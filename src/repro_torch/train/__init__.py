"""Training substrate: optimizer, loop, checkpointing."""
from .optimizer import AdamWConfig  # noqa: F401
from .train_loop import init_state, make_train_step, train  # noqa: F401
