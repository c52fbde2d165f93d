"""The port's binding to the host library (`fiber_torch.native`: CIDEr-D
and greedy NMS from `native/fiber_host.cpp`) against the JAX package's
binding (`fiber_tpu.native`) on the cases of tests/test_native.py, and its
build, which goes to `fiber_torch/_build/` and writes nothing under
`native/`."""

import os

import numpy as np
import pytest

from fiber_torch import native as tnative

jnative = pytest.importorskip("fiber_tpu.native")

CIDER_CASES = {
    "perfect": ({0: [[1, 2, 3, 4, 5, 6]], 1: [[7, 8, 9, 10, 11]]},
                [{0: [1, 2, 3, 4, 5, 6]}]),
    "quality": ({0: [[1, 2, 3, 4, 5], [1, 2, 3, 4, 6]], 1: [[20, 21, 22, 23]],
                 2: [[30, 31, 32, 33]]},
                [{0: [1, 2, 3, 4, 5]}, {0: [1, 2, 99, 98, 97]},
                 {0: [50, 51, 52, 53, 54]}]),
    "length": ({0: [[1, 2, 3, 4, 5]], 1: [[9, 9, 9]]},
               [{0: [1, 2, 3, 4, 5]}, {0: [1, 2, 3, 4, 5] * 4}]),
    "batch": ({i: [[i, i + 1, i + 2, i + 3]] for i in range(5)},
              [{i: [i, i + 1, i + 2, i + 3] for i in range(5)}]),
    "empty_candidate": ({0: [[1, 2, 3]], 1: [[4, 5]]}, [{0: [], 1: [4, 5]}]),
}


@pytest.mark.parametrize("case", sorted(CIDER_CASES))
def test_cider_matches_jax_binding(case):
    refs, queries = CIDER_CASES[case]
    mine, theirs = tnative.CiderD(refs), jnative.CiderD(refs)
    for cands in queries:
        got, want = mine.score(cands), theirs.score(cands)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == want[k], (case, k)


def test_cider_values():
    """tests/test_native.py's expectations, on the port's binding."""
    refs, _ = CIDER_CASES["quality"]
    scorer = tnative.CiderD(refs)
    good = scorer.score({0: [1, 2, 3, 4, 5]})[0]
    partial = scorer.score({0: [1, 2, 99, 98, 97]})[0]
    unrelated = scorer.score({0: [50, 51, 52, 53, 54]})[0]
    assert good > partial > unrelated == pytest.approx(0.0, abs=1e-6)
    refs, _ = CIDER_CASES["perfect"]
    assert tnative.CiderD(refs).score({0: [1, 2, 3, 4, 5, 6]})[0] == \
        pytest.approx(10.0, abs=1e-6)


def test_cider_takes_int64_ids_and_refuses_wider():
    refs = {0: [np.array([1, 2, 3, 4], np.int64)], 1: [[7, 8, 9]]}
    scorer = tnative.CiderD(refs)
    got = scorer.score({0: np.array([1, 2, 3, 4], np.int64)})[0]
    assert got == pytest.approx(10.0, abs=1e-6)
    with pytest.raises(ValueError):
        scorer.score({0: [2 ** 31]})


@pytest.mark.parametrize("threshold", [0.3, 0.5, 0.7])
def test_nms_host_matches_jax_binding(threshold):
    rng = np.random.default_rng(int(threshold * 10))
    centers = rng.uniform(10, 90, (60, 2))
    sizes = rng.uniform(5, 25, (60, 2))
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2],
                           axis=1).astype(np.float32)
    scores = rng.random(60).astype(np.float32)
    for max_outputs in (10, 60):
        got = tnative.nms_host(boxes, scores, threshold, max_outputs)
        want = jnative.nms_host(boxes, scores, threshold, max_outputs)
        np.testing.assert_array_equal(got, want)
        assert 0 < len(got) <= max_outputs


def test_build_goes_to_the_package_and_not_native():
    native_dir = tnative.SOURCE.parent
    before = sorted(os.listdir(native_dir))
    so = tnative.build()
    assert so.parent == tnative.BUILD_DIR and so.exists()
    assert so.name.startswith("libfiber_host_")
    assert tnative.build() == so                  # built once, then loaded
    tnative.CiderD({0: [[1, 2]], 1: [[3]]}).score({0: [1, 2]})
    assert sorted(os.listdir(native_dir)) == before
