"""Kill and resume in the port, on the CPU: a child process fits with
`checkpoint_every=3` and SIGKILLs itself at round 5 (no cleanup, no
atexit), the parent resumes from the snapshot on disk with
`Booster.resume`, and the result is `torch.equal` to an uninterrupted fit
of the port (trees, margins, predictions): the plain versions add in a
fixed order, the snapshot's margins re-enter the loop as carried, and the
draws fold absolute rounds. On the card the same resume agrees with the
uninterrupted fit only within tolerance (atomics; `chip_smoke.py`).

Snapshots cross packages: one the reference wrote mid-fit resumes in the
port (within the fit tolerance of test_torch_booster.py of the reference's
own resume), and one the port wrote loads in the reference.
"""
import os
import signal
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.checkpoint import io as JIO
from repro.core import Booster as JBooster
from repro.core import DeviceDMatrix as JDMatrix
from repro_torch.checkpoint import io as TIO
from repro_torch.core import Booster, DeviceDMatrix, ExternalDMatrix
from repro_torch.core.predict import ENSEMBLE_FIELDS

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)

# Child and parent regenerate the same data from this.
DATA_SETUP = """
import numpy as np
rng = np.random.default_rng(123)
x = rng.normal(size=(512, 6)).astype(np.float32)
y = (x @ rng.normal(size=6) > 0).astype(np.float32)
xv = rng.normal(size=(160, 6)).astype(np.float32)
yv = (xv @ rng.normal(size=6) > 0).astype(np.float32)
"""

VARIANTS = {
    "plain": dict(knobs={}, es=None),
    "early_stopping": dict(knobs={"learning_rate": 1.0}, es=3),
    "subsample": dict(knobs={"subsample": 0.5, "seed": 7}, es=None),
}


def _data():
    ns = {}
    exec(DATA_SETUP, ns)
    return ns["x"], ns["y"], ns["xv"], ns["yv"]


def _kw(variant):
    return dict(n_rounds=10, max_depth=3, max_bins=32, objective="binary:logistic",
                **VARIANTS[variant]["knobs"])


def _matrices(variant):
    x, y, xv, yv = _data()
    d = DeviceDMatrix(x, label=y, max_bins=32, device="cpu")
    evals = ([(DeviceDMatrix(xv, label=yv, ref=d), "val")]
             if VARIANTS[variant]["es"] else [])
    return d, evals


def _run_killed_fit(variant, path, kill_round=5, every=3):
    """The child fits with snapshots every `every` rounds and SIGKILLs
    itself once round `kill_round` has been read."""
    v = VARIANTS[variant]
    script = DATA_SETUP + textwrap.dedent(f"""
        import os, signal
        from repro_torch.core import Booster, DeviceDMatrix
        d = DeviceDMatrix(x, label=y, max_bins=32, device="cpu")
        evals = ([(DeviceDMatrix(xv, label=yv, ref=d), "val")] if {v['es']!r} else [])
        def cb(r, rec):
            if r >= {kill_round}:
                os.kill(os.getpid(), signal.SIGKILL)
        Booster(**{_kw(variant)!r}).fit(d, evals=evals, early_stopping_rounds={v['es']!r},
                                        checkpoint_every={every},
                                        checkpoint_path={path!r}, callback=cb)
        print("FIT-COMPLETED")  # unreachable: the callback kills first
        """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, env=env)
    assert res.returncode == -signal.SIGKILL, f"{res.returncode}\n{res.stdout}\n{res.stderr}"
    assert "FIT-COMPLETED" not in res.stdout


def _assert_equal(ref, got, x):
    assert got.n_rounds_trained == ref.n_rounds_trained
    assert got.best_iteration == ref.best_iteration
    for f in ENSEMBLE_FIELDS:
        assert torch.equal(getattr(ref.ensemble, f), getattr(got.ensemble, f)), f
    assert torch.equal(ref.predict_margins(x), got.predict_margins(x))
    if ref.margins is not None:
        assert torch.equal(ref.margins, got.margins)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_sigkill_then_resume_is_the_uninterrupted_fit(tmp_path, variant):
    path = str(tmp_path / f"{variant}.ckpt")
    _run_killed_fit(variant, path)
    _, rs = TIO.load_booster_with_resume(path, device="cpu")
    assert rs is not None and rs["rounds_done"] == 3 and rs["target"] == 10
    d, evals = _matrices(variant)
    es = VARIANTS[variant]["es"]
    ref = Booster(**_kw(variant)).fit(d, evals=evals, early_stopping_rounds=es)
    d2, evals2 = _matrices(variant)
    got = Booster.resume(path, d2, evals=evals2)
    _assert_equal(ref, got, _data()[0])
    if es:
        assert got.history == ref.history
    # The file now holds the completed fit.
    assert TIO.load_booster_with_resume(path, device="cpu")[1] is None


class _Stop(Exception):
    pass


def _stop_at(round_):
    def cb(r, rec):
        if r >= round_:
            raise _Stop
    return cb


def test_reference_snapshot_resumes_in_the_port(tmp_path):
    """A snapshot the reference wrote mid-fit (stopped after round 5, its
    last snapshot at 3) resumes in the port on the reference's cuts, within
    the fit tolerance of the reference's own resume of the same file."""
    x, y, xv, yv = _data()
    path = str(tmp_path / "jax.ckpt")
    kw = _kw("plain")
    jd = JDMatrix(x, label=y, max_bins=32)
    with pytest.raises(_Stop):
        JBooster(**kw).fit(jd, checkpoint_every=3, checkpoint_path=path, callback=_stop_at(5))
    copy = tmp_path / "copy.ckpt"  # each resume rewrites its file when done
    copy.write_bytes(Path(path).read_bytes())
    mine = Booster.resume(path, DeviceDMatrix(x, label=y, max_bins=32,
                                              cuts=np.asarray(jd.cuts), device="cpu"))
    theirs = JBooster.resume(str(copy), jd)
    assert mine.n_rounds_trained == theirs.n_rounds_trained == 10
    for f in ("feature", "split_bin", "default_left", "is_leaf"):
        np.testing.assert_array_equal(getattr(mine.ensemble, f).numpy(),
                                      np.asarray(getattr(theirs.ensemble, f)))
    np.testing.assert_allclose(mine.ensemble.leaf_value.numpy(),
                               np.asarray(theirs.ensemble.leaf_value), **TOL)
    np.testing.assert_allclose(mine.margins.numpy(), np.asarray(theirs.margins), **TOL)


def test_port_snapshot_loads_and_resumes_in_the_reference(tmp_path):
    """The port's in-run snapshot carries the reference's resume keys; the
    reference loads it with load_booster_with_resume and resumes it."""
    x, y, xv, yv = _data()
    path = str(tmp_path / "torch.ckpt")
    jd = JDMatrix(x, label=y, max_bins=32)
    d = DeviceDMatrix(x, label=y, max_bins=32, cuts=np.asarray(jd.cuts), device="cpu")
    dv = DeviceDMatrix(xv, label=yv, ref=d)
    with pytest.raises(_Stop):
        Booster(**_kw("plain")).fit(d, evals=[(dv, "val")], eval_metric="logloss",
                                    checkpoint_every=4, checkpoint_path=path,
                                    callback=_stop_at(5))
    jb, rs = JIO.load_booster_with_resume(path)
    assert sorted(rs) == sorted(["rounds_done", "target", "rounds_before", "margins",
                                 "eval_margins", "es_history", "early_stopping_rounds",
                                 "checkpoint_every", "verbose_every", "eval_names",
                                 "metric_names"])
    assert (rs["rounds_done"], rs["target"], rs["checkpoint_every"]) == (4, 10, 4)
    assert rs["eval_names"] == ["val"] and rs["metric_names"] == ["logloss"]
    assert jb.n_rounds_trained == 4 and len(jb.history) == 4
    mine = TIO.load_booster_with_resume(path, device="cpu")[1]
    np.testing.assert_array_equal(np.asarray(rs["margins"]), mine["margins"].numpy())
    theirs = JBooster.resume(path, jd, evals=[(JDMatrix(xv, label=yv, ref=jd), "val")])
    assert theirs.n_rounds_trained == 10


def test_chunked_resume_and_resume_errors(tmp_path):
    """A chunked fit stopped after its snapshot resumes, bit for bit its
    uninterrupted fit; a completed checkpoint, other cuts and other eval
    sets are refused with the reference's messages."""
    x, y, xv, yv = _data()
    d = DeviceDMatrix(x, label=y, max_bins=32, device="cpu")
    e = ExternalDMatrix.from_arrays(x, y, chunk_rows=100, ref=d)
    path = str(tmp_path / "ext.ckpt")
    with pytest.raises(_Stop):
        Booster(**_kw("plain")).fit(e, checkpoint_every=3, checkpoint_path=path,
                                    callback=_stop_at(7))
    assert TIO.load_booster_with_resume(path, device="cpu")[1]["rounds_done"] == 6
    got = Booster.resume(path, ExternalDMatrix.from_arrays(x, y, chunk_rows=100, ref=d))
    _assert_equal(Booster(**_kw("plain")).fit(d), got, x)
    with pytest.raises(ValueError, match="COMPLETED"):
        Booster.resume(path, d)
    with pytest.raises(_Stop):
        Booster(**_kw("plain")).fit(d, checkpoint_every=3, checkpoint_path=path,
                                    callback=_stop_at(4))
    with pytest.raises(ValueError, match="different cuts"):
        Booster.resume(path, DeviceDMatrix(x * 2, label=y, max_bins=32, device="cpu"))
    with pytest.raises(ValueError, match="eval sets in order"):
        Booster.resume(path, d, evals=[(DeviceDMatrix(xv, label=yv, ref=d), "val")])
