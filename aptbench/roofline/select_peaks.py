"""K3, the greedy sync walk (summary and walk kernels): one comparison
per valid correlation sample, the correlation read once, the peak list
(with its three-word head) written once."""

NAMES = ("select_summary_kernel", "select_walk_kernel")


def count(g: dict) -> tuple[float, float]:
    n = g["n_valid"]
    return float(n), 4.0 * n + 4.0 * (g["max_peaks"] + 3)
