from .diamond import DiamondInjector, DiamondInjectorPreprocessOut  # noqa: F401
