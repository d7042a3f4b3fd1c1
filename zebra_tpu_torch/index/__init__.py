from zebra_tpu_torch.index.streaming import (
    fill_scan,
    TpprParams,
    TpprQueries,
    TpprState,
    init_tppr_state,
    read_topk,
    streaming_scan,
)

__all__ = [
    "fill_scan",
    "TpprParams",
    "TpprQueries",
    "TpprState",
    "init_tppr_state",
    "read_topk",
    "streaming_scan",
]
