from .diamond_we import DiamondWE, DiamondWECiphertext  # noqa: F401
