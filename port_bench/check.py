"""Whether what the timed path produced is correct: a sample of its answers,
drawn from the seed once the window has closed and spread over the rows of
a request (``Cell.picks``), against the plain fp32 reference
(``reference/``) run on the same inputs, which the cell's kind
(``kinds/<kind>.py``, ``Cell.reference``) makes again from the seed: x_T,
the weights (drawn anew, never the tensors the program was handed), the
inversion's and the drag's noise, the handles. Nothing the program derived
(its latents, records, casts) is read, only the answers it returned.
``rel_err`` = the largest ||program - reference|| / ||reference|| over the
picks; a kind may compare more (``edit``: ``guide_err``).

``quant`` computes the reference's products in a lower precision (the
control, ``calibrate.py``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from port_bench.reference.unet import fp32_strict


def reference(cell, chosen, quant=None):
    fp32_strict()
    return cell.reference(chosen, quant)


def readings(cell) -> Dict[str, float]:
    """The program's numbers: its answers of the picks against the reference."""
    chosen = cell.picks()
    return cell.numbers(cell.answers(chosen), reference(cell, chosen))


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {name: {"value", "limit"}}): every number finite and at
    most its limit; a number with no limit fails."""
    out, ok = {}, True
    for name, v in values.items():
        lim = limits.get(name)
        out[name] = {"value": v, "limit": lim}
        ok = ok and lim is not None and bool(np.isfinite(v)) and v <= lim
    return ok, out
