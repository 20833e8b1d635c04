from .checkpointing import save_checkpoint, load_checkpoint  # noqa: F401
