"""The port's Exp1 baselines against the JAX package's, on the CPU.

Each selector of `repro_torch.core.baselines` and `repro.core.baselines`
runs on the same numpy inputs (a small weighted LR problem; for the random
baseline the same draw, handed to the port through its one drawing
function, `baselines.random_priority`). Priorities agree within the
stated tolerance, suggested labels exactly, and the top-b rows
either agree or differ only at a priority tie.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as j_bl
from repro.core import lr_head as j_lr_head
from repro.core.influence import top_b as j_top_b
from repro_torch.cleaning import BaselineSelector, InflSelector, make_selector
from repro_torch.core import baselines
from repro_torch.core.influence import top_b

N, D, C, A = 150, 9, 3, 3
RTOL, ATOL = 1e-5, 1e-6  # float32 sums in another order, as tests/test_torch_kernels.py


def _softmax(z):
    e = np.exp(z - z.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


@pytest.fixture(scope="module")
def data():
    r = np.random.default_rng(3)
    Xa = r.standard_normal((N, D)).astype(np.float32)
    Xa[:, -1] = 1.0
    Xv = r.standard_normal((31, D)).astype(np.float32)
    Xv[:, -1] = 1.0
    return dict(
        w=(0.4 * r.standard_normal((C, D))).astype(np.float32), w0=np.zeros((C, D), np.float32),
        v=(0.4 * r.standard_normal((C, D))).astype(np.float32),
        Xa=Xa, Y=_softmax(2 * r.standard_normal((N, C))).astype(np.float32),
        gw=np.full(N, 0.8, np.float32), Xv=Xv,
        Yv=np.eye(C, dtype=np.float32)[r.integers(0, C, 31)],
        humans=r.integers(0, C, (N, A)),
        sched=np.asarray(j_lr_head.batch_schedule(9, N, 30, 4), np.int64),
    )


def _calls(a, lib, draw):
    """(method -> selection) for the JAX package (lib = repro's module) or
    the port; `draw` is the random baseline's key or generator."""
    return {
        "infl_d": lambda: lib.select_infl_d(a["w"], a["v"], a["Xa"], a["Y"]),
        "infl_y": lambda: lib.select_infl_y(a["w"], a["v"], a["Xa"], a["Y"]),
        "active_one": lambda: lib.select_active_one(a["w"], a["Xa"]),
        "active_two": lambda: lib.select_active_two(a["w"], a["Xa"]),
        "loss": lambda: lib.select_loss(a["w"], a["Xa"], a["Y"]),
        "random": lambda: lib.select_random(draw, N),
        "o2u": lambda: lib.select_o2u(a["w0"], a["Xa"], a["Y"], a["gw"], a["sched"], l2=0.05,
                                      lr_max=0.4),
        "tars": lambda: lib.select_tars_lite(a["w"], a["Xa"], a["Y"], a["humans"], C),
        "duti": lambda: lib.select_duti_lite(a["w"], a["Xa"], a["Y"], a["gw"], a["Xv"], a["Yv"],
                                             l2=0.05, lr=0.1),
    }


@pytest.mark.parametrize("method", ["infl_d", "infl_y", "active_one", "active_two", "loss",
                                    "random", "o2u", "tars", "duti"])
def test_baseline_matches_jax(method, data, monkeypatch):
    """Priorities allclose (RTOL, ATOL; also through O2U's 100 unrolled steps
    and DUTI's 20 x 8 and its outer gradient), suggested labels equal, the
    top 10 equal up to a tie at the 10th."""
    key = jax.random.key(4)
    monkeypatch.setattr(baselines, "random_priority", lambda n, generator, device:
                        torch.from_numpy(np.array(jax.random.uniform(generator, (n,)))))
    j = {k: jnp.asarray(x) for k, x in data.items()}
    t = {k: torch.from_numpy(np.array(x)) for k, x in data.items()}
    want = _calls(j, j_bl, key)[method]()
    got = _calls(t, baselines, key)[method]()
    np.testing.assert_allclose(got.priority.numpy(), np.asarray(want.priority), rtol=RTOL,
                               atol=ATOL)
    assert (got.suggested is None) == (want.suggested is None)
    if want.suggested is not None:
        np.testing.assert_array_equal(got.suggested.numpy(), np.asarray(want.suggested))
    eligible = np.arange(N) % 7 != 0
    mine = set(top_b(got.priority, torch.from_numpy(eligible), 10).tolist())
    theirs = set(np.asarray(j_top_b(want.priority, jnp.asarray(eligible), 10)).tolist())
    prio = got.priority.numpy()
    bth = max(prio[sorted(mine)])
    assert all(abs(prio[i] - bth) <= 1e-5 * max(1.0, abs(bth)) for i in mine ^ theirs)


def test_make_selector_takes_the_whole_method_vocabulary():
    """Every Exp1 method gets a BaselineSelector with selector 'full';
    Increm-INFL prunes INFL scores only, and unknown names are refused."""
    assert isinstance(make_selector("infl", "increm"), InflSelector)
    for m in ("infl_d", "infl_y", "active_one", "active_two", "o2u", "tars", "duti", "loss",
              "random"):
        assert make_selector(m, "full") == BaselineSelector(m)
    with pytest.raises(ValueError, match="Increm-INFL"):
        make_selector("loss", "increm")
    with pytest.raises(ValueError, match="unknown method"):
        make_selector("oracle", "full")
    with pytest.raises(ValueError, match="unknown selector"):
        make_selector("infl", "partial")
