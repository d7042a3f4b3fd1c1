from zebra_tpu_torch.data.synthetic import Data, synthetic_stream

__all__ = ["Data", "synthetic_stream"]
