"""Checkpoints in the reference's format; counterpart of `repro.checkpoint.io`.

A checkpoint is MAGIC (8 bytes), the payload's crc32 as `>I`, then the
payload: msgpack (`_msgpack.py`, this package's own codec for the subset
checkpoints use) of a tree of maps, lists, scalars and arrays. An array is
the map {"__arr__": True, "d": dtype string, "s": shape, "b": raw bytes}, a
tuple the map {"__tuple__": [...]}, and every other map has its keys
sorted, as the reference's host conversion (`jax.tree.map`) leaves them, so
for the same model both packages write the same bytes. Files written before
the frame existed (raw msgpack) are still read. Writes are atomic and
durable (temporary file, fsync, rename): an interrupted save never corrupts
the previous checkpoint. Truncated or corrupt files, and files of another
format or version, raise `CheckpointError`.

Loading decodes arrays to tensors on the card unless the caller asks for the
CPU (`device="cpu"`). The `checkpoint_write` fault site
(`repro_torch.testing.faults`) fires before any byte is written, as the
reference's does: a write it stops leaves the file on disk as it was.
"""
from __future__ import annotations

import dataclasses
import os
import struct
import tempfile
import zlib

import numpy as np
import torch

from repro_torch.checkpoint import _msgpack
from repro_torch.device import resolve_device

_ARR = "__arr__"
_TUP = "__tuple__"

MAGIC = b"RPROCKPT"  # 8 bytes, followed by crc32(payload) as >I, then payload


class CheckpointError(ValueError):
    """A checkpoint file is missing, corrupt, truncated, or the wrong
    format/version. Subclasses ValueError, as the reference's does."""


def _host(obj):
    """Tensors to numpy, and every map's keys sorted: the tree as the
    reference's `jax.tree.map` hands it to the encoder."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _host(obj[k]) for k in sorted(obj)}
    if isinstance(obj, tuple):
        return tuple(_host(v) for v in obj)
    if isinstance(obj, list):
        return [_host(v) for v in obj]
    return obj


def _encode(obj):
    if isinstance(obj, (np.ndarray, np.generic)):
        a = np.asarray(obj)
        return {_ARR: True, "d": a.dtype.str, "s": list(a.shape), "b": a.tobytes()}
    if isinstance(obj, dict):
        return {str(k): _encode(v) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return {_TUP: [_encode(v) for v in obj]}
    if isinstance(obj, list):
        return [_encode(v) for v in obj]
    if isinstance(obj, (int, float, str, bool)) or obj is None:
        return obj
    raise TypeError(f"cannot checkpoint {type(obj)}")


def _decode(obj, device: torch.device):
    if isinstance(obj, dict):
        if obj.get(_ARR):
            a = np.frombuffer(obj["b"], dtype=np.dtype(obj["d"])).reshape(obj["s"])
            return torch.from_numpy(a.copy()).to(device)
        if _TUP in obj:
            return tuple(_decode(v, device) for v in obj[_TUP])
        return {k: _decode(v, device) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode(v, device) for v in obj]
    return obj


def save_pytree(path: str, tree) -> None:
    from repro_torch.testing import faults

    faults.check("checkpoint_write")
    payload = _msgpack.packb(_encode(_host(tree)))
    framed = MAGIC + struct.pack(">I", zlib.crc32(payload) & 0xFFFFFFFF) + payload
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(framed)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_pytree(path: str, device=None):
    """The tree saved at `path`, its arrays as tensors on `device` (the card
    unless "cpu")."""
    dev = resolve_device(device)
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError as exc:
        raise CheckpointError(f"cannot read checkpoint {path}: {exc}") from exc
    if raw.startswith(MAGIC):
        header_len = len(MAGIC) + 4
        if len(raw) < header_len:
            raise CheckpointError(
                f"checkpoint {path} is truncated inside its header "
                f"({len(raw)} bytes)"
            )
        (expected,) = struct.unpack(">I", raw[len(MAGIC):header_len])
        payload = raw[header_len:]
        got = zlib.crc32(payload) & 0xFFFFFFFF
        if got != expected:
            raise CheckpointError(
                f"checkpoint {path} failed its payload checksum "
                f"(crc32 {got:#010x}, header says {expected:#010x}) — the "
                "file is corrupt or truncated"
            )
    else:
        # Pre-frame checkpoints (written before the magic+crc header) are
        # raw msgpack; keep reading them.
        payload = raw
    try:
        tree = _msgpack.unpackb(payload)
    except Exception as exc:
        raise CheckpointError(
            f"checkpoint {path} is not decodable msgpack: {exc}"
        ) from exc
    return _decode(tree, dev)


def _ensemble_fields_with_gain(fields: dict) -> dict:
    """Backfill `gain` for checkpoints written before gains were stored in
    the arena (importances on such models report zeros: -inf marks every
    slot as "not a known split")."""
    if "gain" not in fields:
        fields = dict(fields)
        lv = fields["leaf_value"]
        fields["gain"] = torch.full(lv.shape, float("-inf"), dtype=torch.float32,
                                    device=lv.device)
    return fields


def save_ensemble(path: str, ens) -> None:
    from repro_torch.core.predict import ENSEMBLE_FIELDS, Ensemble

    assert isinstance(ens, Ensemble)
    save_pytree(path, {
        "fields": {k: getattr(ens, k) for k in ENSEMBLE_FIELDS},
        "n_classes": ens.n_classes,
        "base_score": ens.base_score,
    })


def load_ensemble(path: str, device=None):
    from repro_torch.core.predict import Ensemble

    d = load_pytree(path, device)
    return Ensemble(**_ensemble_fields_with_gain(d["fields"]),
                    n_classes=d["n_classes"], base_score=d["base_score"])


# --- self-describing Booster checkpoints -----------------------------------

BOOSTER_FORMAT = "repro.booster"
BOOSTER_VERSION = 2  # v2 adds the optional in-run "resume" section
_READABLE_VERSIONS = (1, 2)


def save_booster(path: str, bst, *, ensemble=None, n_rounds_trained=None,
                 history=None, resume: dict | None = None) -> None:
    """Versioned checkpoint of a fitted Booster: config + cut points + base
    score + trees + training record; loading needs nothing else.

    The keyword overrides are the reference's, for in-run snapshots (the
    partial ensemble, round count, history and a `resume` section, which
    `Booster._write_checkpoint` writes and `Booster.resume` reads).

    Objectives are stored BY REGISTRY NAME: a model trained with a custom
    objective round-trips iff that objective was added with
    `objectives.register_objective` (in the saving process, and in the
    loading process before the load). A bare callable passed via
    `fit(obj=...)` is rejected with a ValueError naming the fix.
    """
    from repro_torch.core import objectives as O
    from repro_torch.core.predict import ENSEMBLE_FIELDS

    obj = bst.obj
    if O.OBJECTIVES.get(obj.name) is not obj:
        raise ValueError(
            f"objective {obj.name!r} is not in the objective registry; a "
            "bare callable passed via fit(obj=...) cannot be checkpointed "
            "by name. Register it first with "
            "objectives.register_objective(name, grad, ...) and pass the "
            "registered objective (or its name) to fit."
        )
    ens = ensemble if ensemble is not None else bst.ensemble
    payload = {
        "format": BOOSTER_FORMAT,
        "version": BOOSTER_VERSION,
        "config": dataclasses.asdict(bst.cfg),
        "cuts": bst.cuts,
        "base_score": float(bst.base_score),
        "best_iteration": bst.best_iteration,
        "best_score": bst.best_score,
        "n_rounds_trained": int(
            n_rounds_trained if n_rounds_trained is not None
            else bst.n_rounds_trained
        ),
        "history": history if history is not None else bst.history,
        "ensemble": {
            "fields": {k: getattr(ens, k) for k in ENSEMBLE_FIELDS},
            "n_classes": ens.n_classes,
        },
    }
    if resume is not None:
        payload["resume"] = resume
    save_pytree(path, payload)


def _load_booster_payload(path: str, device=None):
    from repro_torch.core import objectives as O
    from repro_torch.core.booster import Booster, BoosterConfig
    from repro_torch.core.predict import Ensemble

    dev = resolve_device(device)
    d = load_pytree(path, dev)
    if d.get("format") != BOOSTER_FORMAT:
        raise CheckpointError(
            f"{path} is not a {BOOSTER_FORMAT} checkpoint "
            f"(format={d.get('format')!r})"
        )
    if d.get("version") not in _READABLE_VERSIONS:
        raise CheckpointError(
            f"unsupported {BOOSTER_FORMAT} checkpoint version "
            f"{d.get('version')!r} in {path} (this build reads "
            f"{_READABLE_VERSIONS})"
        )
    known = {f.name for f in dataclasses.fields(BoosterConfig)}
    cfg = BoosterConfig(**{k: v for k, v in d["config"].items() if k in known})
    if cfg.objective not in O.OBJECTIVES:
        raise CheckpointError(
            f"checkpoint {path} was trained with objective "
            f"{cfg.objective!r}, which is not in this process's objective "
            "registry. Custom objectives must be re-registered before "
            "loading: objectives.register_objective"
            f"({cfg.objective!r}, grad, ...)"
        )
    bst = Booster(cfg)
    bst.device = dev
    bst.cuts = d["cuts"]
    bst.base_score = d["base_score"]
    bst.best_iteration = d["best_iteration"]
    bst.best_score = d["best_score"]
    bst.n_rounds_trained = d["n_rounds_trained"]
    bst.history = d["history"]
    bst.ensemble = Ensemble(
        **_ensemble_fields_with_gain(d["ensemble"]["fields"]),
        n_classes=d["ensemble"]["n_classes"],
        base_score=d["base_score"],
    )
    return bst, d.get("resume")


def load_booster(path: str, device=None):
    bst, _ = _load_booster_payload(path, device)
    return bst


def load_booster_with_resume(path: str, device=None):
    """Load a checkpoint together with its in-run resume section (None for
    checkpoints of completed fits)."""
    return _load_booster_payload(path, device)
