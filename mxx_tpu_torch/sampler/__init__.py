from .dist import BitDist, DistType, FinRingDist, GaussDist, TernaryDist  # noqa: F401
from .samplers import HashSampler, UniformSampler  # noqa: F401
from .trapdoor import Trapdoor, TrapdoorSampler  # noqa: F401
