"""The general drivers that traffic files name by their `driver` key."""

from .bgg import BggPassDriver
from .preimage import PreimageDriver

DRIVERS = {"preimage": PreimageDriver, "bgg_pass": BggPassDriver}
