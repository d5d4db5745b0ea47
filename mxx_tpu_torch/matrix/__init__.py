from .poly_matrix import PolyMatrix  # noqa: F401
