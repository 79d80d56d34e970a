import numpy as np

from consent_jax.io import seqs
from consent_jax.testing import metrics


def brute_edit(a, b):
    la, lb = len(a), len(b)
    dp = np.zeros((la + 1, lb + 1), dtype=np.int64)
    dp[:, 0] = np.arange(la + 1)
    dp[0, :] = np.arange(lb + 1)
    for i in range(1, la + 1):
        for j in range(1, lb + 1):
            dp[i][j] = min(
                dp[i - 1][j - 1] + (a[i - 1] != b[j - 1]),
                dp[i - 1][j] + 1,
                dp[i][j - 1] + 1,
            )
    return int(dp[la][lb])


def test_edit_distance_matches_bruteforce():
    rng = np.random.default_rng(0)
    for _ in range(20):
        a = rng.integers(0, 4, rng.integers(0, 40)).astype(np.uint8)
        b = rng.integers(0, 4, rng.integers(0, 40)).astype(np.uint8)
        assert metrics.edit_distance_banded(a, b, band=50) == brute_edit(a, b)


def test_identity():
    a = seqs.encode("ACGTACGTAC")
    assert metrics.identity(a, a) == 1.0
    b = seqs.encode("ACGTACGTAA")
    assert abs(metrics.identity(a, b) - 0.9) < 1e-9
