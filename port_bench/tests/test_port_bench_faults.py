"""``correct`` comes out false when the timed path is broken underneath.
Each test skips the look for a card and drives the rest of a run of the
cell at miniature size in fp32, where the sound program meets the cell's
limits, under each fault that its kind lists (``FAULTS`` of
``kinds/<kind>.py``): a step that returns its state unchanged, half of the
batch left out with the mean taken over the rest, an answer altered where
it is produced, and for a drag its gradient lost. (No cell spans chips, so
no exchange between chips can be left out.) The control, computed in fp8,
reads well above the program at the same size.
"""

import time

import numpy as np
import pytest
import torch

from port_bench import check
from port_bench.reference.unet import fp8_quant
from port_bench.run import measure
from port_bench.spec import load
from port_bench.tests.mini import CELLS, benchmark, mini

CELL_FAULTS = [(c, f) for c in CELLS for f in sorted(load(c, benchmark()).kind.FAULTS)]


def _limits(cell):
    return load(cell, benchmark()).traffic["limits"]


def _run(cell):
    return measure(mini(cell, _limits(cell), dtype="float32"), 2 ** 32 + 17, 0.1, False,
                   device="cpu", t0=time.time())


@pytest.mark.parametrize("cell", CELLS)
def test_the_sound_miniature_is_correct(cell):
    assert _run(cell)["correct"]


@pytest.mark.parametrize("cell,fault", CELL_FAULTS)
def test_a_fault_makes_the_run_incorrect(cell, fault, monkeypatch):
    load(cell, benchmark()).kind.FAULTS[fault](monkeypatch)
    line = _run(cell)
    assert line["correct"] is False, line["check"]


@pytest.mark.parametrize("seed", range(8))
def test_two_picks_take_one_row_from_each_half_of_the_batch(seed):
    from port_bench.traffic import Traffic

    picks = Traffic({}, 2 ** 31 + seed).check_picks(7, 16, 2)
    assert len(picks) == 2 and (6 in [r for r, _ in picks])
    assert sorted(row // 8 for _, row in picks) == [0, 1]


@pytest.mark.parametrize("cell", ["chairs-gen-b32", "chairs-edit-b16"])
def test_the_fp8_control_reads_above_the_bf16_program(cell):
    spec = mini(cell, _limits(cell))
    c = spec.kind.Cell(spec.config, spec.traffic, 77, torch.device("cpu"), None)
    c.setup()
    c.open_window()
    c.request(0)
    chosen = c.picks()
    ref = check.reference(c, chosen)
    program = c.numbers(c.answers(chosen), ref)
    control = c.numbers(list(check.reference(c, chosen, fp8_quant)["edited"]), ref)
    assert control["rel_err"] > 2 * program["rel_err"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's own size")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_limits_at_the_cells_size(cell, card):
    """On the card: one seed of the program meets every limit, the control
    fails one (``calibrate.py`` reads a dozen seeds)."""
    from port_bench.calibrate import one_seed

    spec = load(cell, benchmark())
    row = one_seed(spec, 2 ** 31 + 101, True)
    lim = spec.traffic["limits"]
    assert all(v <= lim[k] for k, v in row["program"].items()), row
    assert any(v > lim[k] for k, v in row["control"].items()), row
    assert np.isfinite(list(row["program"].values())).all()
