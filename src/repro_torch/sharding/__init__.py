"""Sharding rules (spec tuples and DTensor placements) for the production meshes."""
from .specs import (  # noqa: F401
    apply_fsdp,
    cache_specs,
    data_axes,
    decode_input_specs,
    param_specs,
    placements,
    train_batch_specs,
)
