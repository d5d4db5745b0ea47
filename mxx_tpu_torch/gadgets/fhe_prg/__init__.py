from .goldreich import (  # noqa: F401
    GoldreichEdge,
    GoldreichFheCbdPrg,
    GoldreichFhePrg,
    GoldreichGraph,
    minimum_goldreich_input_size,
)
