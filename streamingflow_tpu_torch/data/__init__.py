from .synthetic import flagship_config, make_batch, tiny_config  # noqa: F401
