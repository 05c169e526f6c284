"""driver_idle_ms_per_solve: the card's idle time in the traced window
under the program's own spans (the gaps that harness/trace.reduce names
by a span whose name starts with `qcqp.`: the restart driver's steps and
the kernels' host preparation, qcqp_tpu_torch.diagnostics.span), in ms a
solve; on several cards the rank with the most.

A floor: the reduction keeps only the TOP largest gap names, so a small
gap under a `qcqp.` span can fall out of the sum.  None where a rank's
trace holds no launch (the harness's CPU runs: the idle time of a device
that ran nothing says nothing), and None for a program that emits no
such span."""

import importlib

PREFIX = "qcqp."


def _program_spans() -> bool:
    try:
        diagnostics = importlib.import_module("qcqp_tpu_torch.diagnostics")
    except ImportError:
        return False
    return hasattr(diagnostics, "span")


def read(run):
    per_rank = []
    for r in run["ranks"]:
        if not r["trace"]["launches"]:
            return None
        idle = sum(s for name, s in r["trace"]["idle"]
                   if name.split("/")[0].startswith(PREFIX))
        per_rank.append(1e3 * idle / r["solves"])
    return max(per_rank) if _program_spans() else None
