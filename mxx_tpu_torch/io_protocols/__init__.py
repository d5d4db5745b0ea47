from .diamond_io import DiamondIO, DiamondIOObf  # noqa: F401
