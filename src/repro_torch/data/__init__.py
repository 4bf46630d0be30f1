from repro_torch.data.pipeline import Prefetcher, TokenStream
from repro_torch.data.synthetic import (
    lm_token_batch,
    lowrank_stream,
    msd_like,
    pamap_like,
    site_assignment,
    zipfian_stream,
)
