from .encoding import BggEncoding  # noqa: F401
from .public_key import BggPublicKey  # noqa: F401
from .sampler import BGGEncodingSampler, BGGPublicKeySampler  # noqa: F401
