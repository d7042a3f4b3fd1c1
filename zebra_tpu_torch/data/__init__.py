from zebra_tpu_torch.data.dataset import Data, DatasetSplits, split_data
from zebra_tpu_torch.data.sampler import RandEdgeSampler
from zebra_tpu_torch.data.synthetic import synthetic_stream

__all__ = ["Data", "DatasetSplits", "RandEdgeSampler", "split_data",
           "synthetic_stream"]
