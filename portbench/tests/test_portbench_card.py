"""On the card: the program's outputs pass the check where the control
(the reference in float32 in the program's place) fails it, at a size a
test run holds. Skips without a CUDA device; run on the chip with

    python -m pytest portbench/tests/test_portbench_card.py -q

(``python -m portbench.control`` reads the same at a cell's own size.)
"""

import types

import pytest


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2147483701, 3000000019])
def test_the_control_fails_where_the_program_passes(seed):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from portbench.harness import run_cell

    run = types.SimpleNamespace(workload="ont-cdna-96loci.pipeline", seed=seed, seconds=0,
                                trace=0)
    code, res = run_cell(run, sample=dict(n_genes=24), control=True)
    assert code == 0 and res["device"]["platform"] == "gpu"
    assert res["correct"] is True, res["checks"]
    assert any(c["value"] > c["limit"] for c in res["control_checks"].values()), res
