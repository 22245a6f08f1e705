"""The reader of ``plan_on_card.qps``: the share of a traced run's batches
whose plan ran on the index's device (``quake.plan.on_card`` spans over
``quake.search_batch`` spans), in a traced CPU rehearsal of each cell."""
import pytest

from test_qbench_program_spans import APS, NPROBE, _run, fresh_totals  # noqa: F401


@pytest.mark.parametrize("planner,share", [("vectorized", 0.0),
                                           ("fused", 100.0)])
@pytest.mark.parametrize("name", [APS, NPROBE])
def test_plan_on_card_share(name, planner, share, fresh_totals,
                            monkeypatch):
    """Every traced batch planned on the card (the fused planner, the
    default on a card index: forced here) reads 100, the host planner 0."""
    from repro_torch.core import multiquery as mq
    monkeypatch.setattr(mq, "default_planner", lambda device: planner)
    r = _run(name, trace=True)
    assert r["correct"] is True
    assert r["metrics"]["plan_on_card.qps"]["value"] == share


def test_untraced_run_reads_no_share(fresh_totals):
    assert "plan_on_card.qps" not in _run(NPROBE, trace=False)["metrics"]
