"""One short run of each cell on the card at the tests' sizes (skips
without a card)."""
import time

import pytest

from portbench.lib import harness


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["scan500k.stream", "scan500k.cluster_only",
                                  "scan500k.session", "slam100.loop"])
@pytest.mark.parametrize("trace", [False, True])
def test_a_short_run_on_the_card_is_correct(bench, tiny, card, name, trace):
    res = harness.run_spec(bench, *tiny(name), 2**31 + 1, 0.5, trace, card,
                           time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    if trace:
        assert res["device"]["busy_s"] > 0
