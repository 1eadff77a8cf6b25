"""The router's balance over the window: for each routed layer the rows
sent to its busiest expert over the mean rows an expert got (the engine's
device counter, `stats()["moe_expert_rows"]`), the largest over the
layers. 1 is an even load; K7's blocks of a busier expert take more
passes."""

from perfbench.metrics import _mla_moe


def read(trace):
    f = _mla_moe.facts(trace)
    rows = f.get("moe_expert_rows") if f is not None else None
    if not rows:
        return None
    worst = [max(r) * len(r) / sum(r) for r in rows if sum(r) > 0]
    return max(worst) if worst else None
