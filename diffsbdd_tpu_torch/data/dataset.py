"""Shape bucketing of the padded node axes."""
from __future__ import annotations

import math


def round_to_bucket(n: int, bucket: int, minimum: int = 0) -> int:
    """Smallest multiple of ``bucket`` >= n (and >= ``minimum``, >= bucket)."""
    return max(int(math.ceil(n / bucket)) * bucket, minimum, bucket)
