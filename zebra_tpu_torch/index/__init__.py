from zebra_tpu_torch.index.streaming import (
    TpprParams,
    TpprQueries,
    TpprState,
    init_tppr_state,
    read_topk,
    streaming_scan,
)

__all__ = [
    "TpprParams",
    "TpprQueries",
    "TpprState",
    "init_tppr_state",
    "read_topk",
    "streaming_scan",
]
