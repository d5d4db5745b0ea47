from .circuit import PolyCircuit  # noqa: F401
from .gate import Gate, SlotTransferSpec  # noqa: F401
