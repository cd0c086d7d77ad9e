"""On the card, at each cell's own size: the program's window judged
correct and the control (the reference's solve in bfloat16 in the
program's place) judged not correct, on three seeds. Run through the chip
tool with ``python3 -m pytest -m cuda benchmark/tests -q``."""

import pytest

from benchmark import spec

SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in
                                  spec.load_benchmark()["workloads"]])
def test_program_correct_and_control_not(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from benchmark.control import readings
    from benchmark.run import card

    cell = spec.find_cell(name)
    dev = card(cell.chips)
    for seed in SEEDS:
        out = readings(cell, seed, 3.0, dev)
        assert out["program_correct"], out
        assert not out["control_correct"], out
