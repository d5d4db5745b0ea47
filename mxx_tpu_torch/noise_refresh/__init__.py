from .refresh import (  # noqa: F401
    NoiseRefresher,
    round_keep_low_bits,
    simulate_noise_refresh_error_growth,
)
