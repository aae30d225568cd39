"""The paper's evaluation in the port against the reference's, on the CPU:
Tables II-VI and the rows that map networks (Fig. 11 against Gemmini,
Tables II and V, the instruction overhead; ``repro_torch.e2e.
run_network_lego`` with the torch engine on the CPU), each run in this
process beside ``benchmarks/run.py``'s, rows equal with only the timings
masked and no FIFO fed by a FIFO in any design built
(tests/_paper_parity.py)."""

import pytest

from _paper_parity import TABLES, check_function


@pytest.mark.parametrize("name", TABLES)
def test_rows_match_reference(name, monkeypatch):
    check_function(name, monkeypatch)
