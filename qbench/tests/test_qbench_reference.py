"""The reference against brute force in numpy, and the comparison that
decides ``correct`` against answers altered by hand."""
import numpy as np
import pytest
import torch

from qbench import reference

RNG = np.random.default_rng(0)
X = (RNG.normal(size=(400, 12)) * 3).astype(np.float32)
Q = (X[RNG.integers(0, 400, 40)]
     + RNG.normal(size=(40, 12)).astype(np.float32) * 0.1)


def _brute(q, x, k):
    d = ((q[:, None, :].astype(np.float64) - x[None].astype(np.float64))
         ** 2).sum(-1)
    return np.argsort(d, axis=1, kind="stable")[:, :k], np.sort(d, 1)[:, :k]


def test_exact_topk_matches_numpy():
    d, i = reference.exact_topk(torch.tensor(Q), torch.tensor(X), 10,
                                block=16)
    want_i, want_d = _brute(Q, X, 10)
    assert np.array_equal(np.sort(i.numpy(), 1), np.sort(want_i, 1))
    assert np.allclose(d.numpy(), want_d, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("block", [7, 40, 1024])
def test_exact_topk_blocks_agree(block):
    d, i = reference.exact_topk(torch.tensor(Q), torch.tensor(X), 10,
                                block=block)
    want_i, want_d = _brute(Q, X, 10)
    assert np.array_equal(np.sort(i.numpy(), 1), np.sort(want_i, 1))
    assert np.allclose(d.numpy(), want_d, rtol=1e-4, atol=1e-3)


def _answers():
    want_i, want_d = _brute(Q, X, 10)
    return (torch.tensor(want_i), torch.tensor(want_d),
            torch.tensor(want_i))


def _judge(ids, dists, want, **kw):
    s = reference.judge(ids, dists, torch.tensor(Q), torch.tensor(X), want,
                        block=16, **kw)
    return {k: float(v) for k, v in s.items()}


def test_sound_answers_pass():
    ids, dists, want = _answers()
    s = _judge(ids, dists, want)
    assert s["dist_gap"] < 1e-6 and s["bad_ids"] == 0
    assert s["unsorted"] == 0 and s["empty"] == 0
    assert s["recall"] == pytest.approx(40.0)


def test_recall_counts_the_exact_ids_held():
    ids, dists, want = _answers()
    ids[0, 9] = -1                     # a miss: no answer, costs recall
    dists[0, 9] = float("inf")
    ids[1, :5] = want[2, :5]           # another query's rows, 5 of 10
    s = _judge(ids, dists, want)
    assert s["recall"] == pytest.approx(40.0 - 0.1 - 0.5)


def test_altered_answer_is_caught():
    ids, dists, want = _answers()
    ids[3, 0] = (ids[3, 0] + 7) % 400
    s = _judge(ids, dists, want)
    assert s["dist_gap"] > 1e-3


def test_repeat_out_of_range_and_missing_answers_are_caught():
    ids, dists, want = _answers()
    ids[0, 1] = ids[0, 0]
    ids[1, :] = -1
    dists[1, :] = float("inf")
    ids[2, 2] = 999
    s = _judge(ids, dists, want)
    assert s["bad_ids"] == 2 and s["empty"] == 1
    ids, dists, want = _answers()
    dists[5, 3] = float("nan")         # an id with no finite distance
    assert _judge(ids, dists, want)["bad_ids"] == 1


def test_unsorted_rows_are_caught():
    ids, dists, want = _answers()
    ids[4, [0, 1]] = ids[4, [1, 0]]
    dists[4, [0, 1]] = dists[4, [1, 0]]
    assert _judge(ids, dists, want)["unsorted"] == 1


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -12, 1.0 + 3 * 2 ** -12,
                      -3.0000002])
    r = reference.tf32_round(x)
    assert r[0] == 1.0 + 2 ** -10
    assert r[1] == 1.0 + 2 ** -11 or r[1] == 1.0
    assert r[2] == 1.0 + 2 ** -10
    assert r[3] == -3.0


def test_tf32_control_reads_far_above_f32():
    """The control: the reference in TF32 in the program's place reads a
    distance gap far over the f32 reference's own."""
    q, x = torch.tensor(Q) * 10, torch.tensor(X) * 10
    want_d, want_i = reference.exact_topk(q, x, 10)
    cd, ci = reference.exact_topk(q, x, 10, tf32=True)
    sound = reference.judge(want_i, want_d, q, x, want_i)
    ctrl = reference.judge(ci, cd, q, x, want_i)
    assert float(ctrl["dist_gap"]) > 30 * float(sound["dist_gap"])
