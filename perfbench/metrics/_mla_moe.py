"""What the `dsv2_serve.*` readers share: a trace of the MLA + MoE serving
driver, and its kernels by name (K6 "mla_decode", K7 "moe_int8", K2
"int8_mma" / "int8_matmul", as `serve.k2_roofline` reads K2)."""

from __future__ import annotations

K6 = ("mla_decode",)
K7 = ("moe_int8",)
K2 = ("int8_mma", "int8_matmul")


def facts(trace):
    """The trace's facts, or None where it is not this driver's."""
    if trace is None or trace.facts.get("driver") != "serve_mla_moe":
        return None
    return trace.facts
