"""tests/torch_once.py's `once_per_run`: one computation a key and a run,
its stored value loaded by every later call."""

import numpy as np

from tests import torch_threads  # noqa: F401
from tests.torch_once import once_per_run


def test_once_per_run_computes_each_key_once(tmp_path_factory):
    calls = []

    def compute(seed):
        def run():
            calls.append(seed)
            rng = np.random.RandomState(seed)
            return {"a": rng.uniform(size=(3, 5)).astype(np.float32),
                    "b": [rng.randint(0, 9, 4), np.float32(seed)]}
        return run

    def once(*seeds):
        got = once_per_run(tmp_path_factory, "once_self_test",
                           {s: compute(s) for s in seeds})
        assert list(got) == list(seeds)
        return got

    first = once(1)[1]
    again = once(1)[1]
    assert calls == [1]
    np.testing.assert_array_equal(again["a"], first["a"])
    assert again["a"].dtype == np.float32
    np.testing.assert_array_equal(again["b"][0], first["b"][0])
    assert again["b"][1] == first["b"][1]
    both = once(2, 1)
    assert calls == [1, 2]
    np.testing.assert_array_equal(both[1]["a"], first["a"])
    assert not np.array_equal(both[2]["a"], first["a"])
