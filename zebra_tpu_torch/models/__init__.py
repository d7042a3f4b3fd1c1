from zebra_tpu_torch.models.memory import MemoryState, init_memory
from zebra_tpu_torch.models.tgn import init_tgn_params

__all__ = ["MemoryState", "init_memory", "init_tgn_params"]
