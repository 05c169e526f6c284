"""collective_ms_per_solve: the NCCL kernels' device time in the traced
window a solve, on the rank with the most (a rank that waits for the
others shows its wait there).  None where no NCCL kernel ran."""


def read(run):
    per_rank = []
    for r in run["ranks"]:
        names = [k for k in r["trace"]["launches"] if "nccl" in k.lower()]
        if not names:
            return None
        total = sum(sum(r["trace"]["launches"][k]) for k in names)
        per_rank.append(1e3 * total / r["solves"])
    return max(per_rank)
