from .aky24_io import Aky24IO, Aky24IOFuncType, aky24_io_find_crt_depth, simulate_aky24_io  # noqa: F401
from .diamond_io import DiamondIO, DiamondIOObf  # noqa: F401
