"""Checkpoint and resume of state trees, in the JAX package's file format.

Port of the JAX package's `io/checkpoint.py`. A tree of tensors, arrays
and scalars (a list of `SlamState`s, a raw grid, a dict) round-trips
exactly through one `.npz` file with the config JSON embedded. Leaves are
keyed by their path, as the JAX package keys a pytree: a NamedTuple's
field name, a list or tuple index, a dict key (dicts in sorted key order),
joined with dots (`0.graph.poses`). The leaf order, the keys, the per-leaf
CRC32 and the meta record are the JAX package's, so a checkpoint written
by either package loads in the other (`tests/test_torch_checkpoint.py`).

Integrity: `save_checkpoint` writes through a temporary file and an
atomic rename, rotates the previous file to `.prev` (never a corrupt
one) and, with `retain_generations` > 2, keeps numbered `.genNNNNNN`
generations; `load_checkpoint` verifies each leaf's CRC32 and raises
`CheckpointCorrupt` on damage; `load_checkpoint_with_fallback` walks the
generations newest first. Sidecars next to a checkpoint carry the map
prior (`.prior`), the voxel grid (`.voxel`), the depth-keyframe ring
(`.voxelkf`) and the bounded-memory world's window manifest (`.world`).
"""

from __future__ import annotations

import glob
import io
import json
import os
import re
import threading
import zipfile
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from jax_mapping_torch.obs.recorder import flight_recorder

_META_KEY = "__jax_mapping_meta__"

#: Fallback-slot load counters: which generation
#: `load_checkpoint_with_fallback` actually resumed from, so a silent
#: `.prev` rescue is distinguishable from a clean primary load. The HTTP
#: plane renders them as `jax_mapping_checkpoint_fallback_total{slot=...}`;
#: all three slots always report (an absent label and a zero counter mean
#: different things to a rate() query).
_FALLBACK_SLOTS = ("primary", "prev", "generation")
_fallback_lock = threading.Lock()
_fallback_counts: Dict[str, int] = {s: 0 for s in _FALLBACK_SLOTS}


class CheckpointCorrupt(ValueError):
    """A checkpoint file exists but cannot be trusted: a truncated zip,
    unreadable meta, or a per-leaf CRC32 mismatch. A ValueError, so
    every load-error handler still catches it; the mapper restart
    catches it to fall back to an older generation."""


def fallback_slot(path: str, used_path: str) -> str:
    """Which retention slot `used_path` is for checkpoint `path`:
    primary, the rotated `.prev`, or a numbered `.genNNNNNN`."""
    if used_path == path:
        return "primary"
    if used_path == previous_checkpoint_path(path):
        return "prev"
    return "generation"


def fallback_counts() -> Dict[str, int]:
    """Snapshot of the per-slot fallback-load counters."""
    with _fallback_lock:
        return dict(_fallback_counts)


def previous_checkpoint_path(path: str) -> str:
    """Rotation slot of the last-good checkpoint: `save_checkpoint`
    moves an intact existing file here before installing the new one."""
    root, ext = os.path.splitext(path)
    return root + ".prev" + (ext or ".npz")


def generation_paths(path: str) -> List[str]:
    """Numbered retained generations of checkpoint `path`, OLDEST first.
    They exist only when saves run with `retain_generations` > 2."""
    root, ext = os.path.splitext(path)
    ext = ext or ".npz"
    pat = re.compile(re.escape(root) + r"\.gen(\d{6})" + re.escape(ext)
                     + r"$")
    out = []
    for p in sorted(glob.glob(root + ".gen??????" + ext)):
        m = pat.match(p)
        if m:
            out.append((int(m.group(1)), p))
    return [p for _, p in sorted(out)]


def _generation_path(path: str, idx: int) -> str:
    root, ext = os.path.splitext(path)
    return f"{root}.gen{idx:06d}" + (ext or ".npz")


def _next_generation_path(path: str) -> str:
    gens = generation_paths(path)
    if not gens:
        return _generation_path(path, 0)
    last = int(re.search(r"\.gen(\d{6})", gens[-1]).group(1))
    return _generation_path(path, last + 1)


def _gc_generations(path: str, retain_generations: int) -> None:
    """Delete numbered generations beyond the retention budget (which
    counts current + `.prev` + numbered files). When both rotation
    slots are rotten, the newest intact numbered generation is spared
    whatever the budget: GC never deletes the only resume source."""
    gens = generation_paths(path)
    budget = max(0, retain_generations - 2)
    doomed = gens[:len(gens) - budget] if budget else list(gens)
    if not doomed:
        return
    if not (_looks_intact(path)
            or _looks_intact(previous_checkpoint_path(path))):
        for g in reversed(gens):
            if _looks_intact(g):
                doomed = [d for d in doomed if d != g]
                break
    for d in doomed:
        try:
            os.unlink(d)
        except OSError:
            pass                         # a racing GC already took it


# ---------------------------------------------------------------------------
# Trees: the JAX package's flatten-with-paths layout
# ---------------------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix: Tuple[str, ...] = ()) -> List[tuple]:
    """[(key, leaf)] in the JAX package's leaf order: NamedTuple fields
    in order, sequences by index, dicts by sorted key; None holds no
    leaf."""
    if tree is None:
        return []
    if _is_namedtuple(tree):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    elif isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    else:
        return [(".".join(prefix) or "value", tree)]
    out = []
    for name, v in items:
        out += _flatten(v, prefix + (name,))
    return out


def _unflatten(template, leaves: iter):
    """`template`'s structure with its leaves taken in order from
    `leaves`."""
    if template is None:
        return None
    if _is_namedtuple(template):
        return type(template)(*(_unflatten(v, leaves) for v in template))
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves) for v in template)
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    return next(leaves)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _like(arr: np.ndarray, tmpl):
    """`arr` in the template leaf's dtype (and, for a tensor, on its
    device)."""
    if isinstance(tmpl, torch.Tensor):
        dtype = torch.empty((), dtype=tmpl.dtype).numpy().dtype
        # astype copies C-contiguous and keeps a 0-d leaf 0-d.
        return torch.as_tensor(arr.astype(dtype), device=tmpl.device)
    return np.asarray(arr.astype(np.asarray(tmpl).dtype))


def _leaf_crc(arr: np.ndarray) -> int:
    """CRC32 over the raw leaf bytes (C-contiguous): a re-zipped file
    with changed leaf bytes passes zip's own checks, not this one."""
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _read_meta(path: str) -> dict:
    with np.load(path) as z:
        return json.loads(bytes(z[_META_KEY].tobytes()).decode())


# ---------------------------------------------------------------------------
# Save / load
# ---------------------------------------------------------------------------

def save_checkpoint(path: str, state: Any,
                    config_json: Optional[str] = None,
                    retain_generations: int = 2) -> None:
    """Write `state` (any tree of tensors, arrays and scalars) to `path`
    atomically, each leaf with its CRC32. An intact file already at
    `path` rotates to `previous_checkpoint_path(path)`; with
    `retain_generations` K > 2 the outgoing `.prev` becomes a numbered
    generation and the oldest beyond K are deleted."""
    if retain_generations < 2:
        raise ValueError(
            f"retain_generations={retain_generations} < 2: the current "
            "+ .prev last-good pair is the corruption-fallback floor")
    arrays = {}
    keys = []
    crcs = {}
    for key, leaf in _flatten(state):
        if key in arrays:
            raise ValueError(f"duplicate checkpoint key {key}")
        arrays[key] = _to_numpy(leaf)
        crcs[key] = _leaf_crc(arrays[key])
        keys.append(key)
    meta = {
        "keys": keys,
        "treedef": type(state).__name__,   # debugging aid only
        "config": config_json,
        "crc32": crcs,
        "version": 1,
    }
    arrays[_META_KEY] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
    if os.path.exists(path) and _looks_intact(path):
        # Rotate ONLY a structurally sound file into the last-good slot:
        # rotating a damaged primary would evict the genuine last-good
        # generation.
        prev = previous_checkpoint_path(path)
        if retain_generations > 2 and os.path.exists(prev) \
                and _looks_intact(prev):
            os.replace(prev, _next_generation_path(path))
        os.replace(path, prev)
    os.replace(tmp, path)
    if retain_generations > 2:
        _gc_generations(path, retain_generations)
    flight_recorder.record("checkpoint_save", name=os.path.basename(path))


def _looks_intact(path: str) -> bool:
    """Structural sanity for rotation: a readable zip with a meta member."""
    try:
        _read_meta(path)
        return True
    except Exception:                        # noqa: BLE001
        return False


def load_checkpoint(path: str, like: Any) -> Tuple[Any, Optional[str]]:
    """Read a checkpoint into the structure of the template tree `like`
    (e.g. a list of `init_state(cfg, device=...)`), returning (state,
    config_json). Leaves take the template leaf's dtype and device; a
    shape mismatch raises ValueError naming the leaf. A file that cannot
    be read or fails a leaf's CRC32 raises `CheckpointCorrupt`; a missing
    one FileNotFoundError."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    try:
        with np.load(path) as z:
            meta = json.loads(bytes(z[_META_KEY].tobytes()).decode())
            data = {k: z[k] for k in meta["keys"]}
    except (OSError, KeyError, ValueError, json.JSONDecodeError,
            zipfile.BadZipFile, zlib.error) as e:
        raise CheckpointCorrupt(
            f"checkpoint {path} is unreadable ({type(e).__name__}: {e})"
        ) from e
    crcs = meta.get("crc32")
    if crcs is not None:
        bad = [k for k in meta["keys"]
               if k in crcs and _leaf_crc(data[k]) != crcs[k]]
        if bad:
            raise CheckpointCorrupt(
                f"checkpoint {path} failed CRC32 verification on "
                f"leaves {bad} — corrupted on disk")

    flat = _flatten(like)
    if len(flat) != len(meta["keys"]):
        raise ValueError(
            f"checkpoint has {len(meta['keys'])} leaves, template has "
            f"{len(flat)} — config/shape drift?")
    new_leaves = []
    for key, tmpl in flat:
        if key not in data:
            raise ValueError(f"checkpoint missing leaf {key!r}")
        arr = data[key]
        tshape = tuple(np.shape(_to_numpy(tmpl))) \
            if not isinstance(tmpl, torch.Tensor) else tuple(tmpl.shape)
        if arr.shape != tshape:
            raise ValueError(
                f"checkpoint leaf {key!r} shape {arr.shape} != template "
                f"{tshape} — was the config changed?")
        new_leaves.append(_like(arr, tmpl))
    flight_recorder.record("checkpoint_load", name=os.path.basename(path))
    return _unflatten(like, iter(new_leaves)), meta["config"]


def load_checkpoint_with_fallback(path: str, like: Any
                                  ) -> Tuple[Any, Optional[str], str]:
    """`load_checkpoint`, degrading to older generations: the primary,
    then `.prev`, then the numbered generations newest first. Returns
    (state, config_json, used_path); only when every generation fails
    does the primary's error propagate (CheckpointCorrupt, or
    FileNotFoundError when there is none). The slot used is
    flight-recorded."""
    candidates = [path, previous_checkpoint_path(path)]
    candidates += list(reversed(generation_paths(path)))
    first_err: Optional[Exception] = None
    for p in candidates:
        try:
            state, cfg_json = load_checkpoint(p, like)
        except (CheckpointCorrupt, FileNotFoundError) as e:
            if first_err is None:
                first_err = e
            continue
        slot = fallback_slot(path, p)
        with _fallback_lock:
            _fallback_counts[slot] += 1
        flight_recorder.record("checkpoint_fallback", slot=slot,
                               name=os.path.basename(p),
                               fell_back=slot != "primary")
        return state, cfg_json, p
    raise first_err


# ---------------------------------------------------------------------------
# Sidecars
# ---------------------------------------------------------------------------

def _check_config(what: str, cfg_json: Optional[str],
                  running_config_json: Optional[str]) -> None:
    from jax_mapping_torch.config import configs_equivalent
    if cfg_json is not None and running_config_json is not None \
            and not configs_equivalent(cfg_json, running_config_json):
        raise ValueError(
            f"{what} sidecar config differs from the running config")


def _sentinel_in_keys(path: str, sentinel: str) -> bool:
    try:
        return sentinel in _read_meta(path).get("keys", [])
    except Exception:                        # noqa: BLE001
        return False


def _meta_kind_is(path: str, kind: str) -> bool:
    try:
        return _read_meta(path).get("kind") == kind
    except Exception:                        # noqa: BLE001
        return False


def voxel_sidecar_path(path: str) -> str:
    """The 3D voxel grid's sidecar next to a 2D checkpoint."""
    root, ext = os.path.splitext(path)
    return root + ".voxel" + (ext or ".npz")


#: Leaf marking a voxel sidecar: checkpoint "x"'s sidecar shares its name
#: with a checkpoint named "x.voxel", and a save must not clobber one
#: with the other.
_VOXEL_SENTINEL = "voxel_sidecar_marker"


def save_voxel_sidecar(path: str, grid: Any,
                       config_json: Optional[str] = None) -> str:
    """Write the 3D grid as `path`'s sidecar; returns the sidecar path.
    Refuses to overwrite a file there that is not a voxel sidecar."""
    vp = voxel_sidecar_path(path)
    if os.path.exists(vp) and not _sentinel_in_keys(vp, _VOXEL_SENTINEL):
        raise ValueError(
            f"{vp} exists and is not a voxel sidecar (a checkpoint named "
            f"with the reserved '.voxel' suffix?); refusing to overwrite")
    save_checkpoint(vp, {"grid": grid, _VOXEL_SENTINEL: np.int8(1)},
                    config_json=config_json)
    return vp


def load_voxel_sidecar(path: str, template_grid: Any,
                       running_config_json: Optional[str] = None) -> Any:
    """`path`'s 3D sidecar grid in the template's dtype and device, or
    None when there is none. ValueError on a non-sidecar file, shape
    drift or config drift."""
    vp = voxel_sidecar_path(path)
    if not os.path.exists(vp):
        return None
    if not _sentinel_in_keys(vp, _VOXEL_SENTINEL):
        raise ValueError(
            f"{vp} is not a voxel sidecar (name collision with a "
            f"checkpoint named '.voxel'?); refusing to load")
    state, cfg_json = load_checkpoint(
        vp, {"grid": template_grid, _VOXEL_SENTINEL: np.int8(0)})
    _check_config("voxel", cfg_json, running_config_json)
    return state["grid"]


def prior_sidecar_path(path: str) -> str:
    """The imported map prior's sidecar next to a 2D checkpoint: a
    resumed session keeps its prior, which closure re-fusions backfill
    from."""
    root, ext = os.path.splitext(path)
    return root + ".prior" + (ext or ".npz")


_PRIOR_SENTINEL = "prior_sidecar_marker"


def save_prior_sidecar(path: str, prior: Any,
                       config_json: Optional[str] = None) -> str:
    """Write the map prior as `path`'s .prior sidecar; returns the path.
    The same clobber guard as the voxel sidecar."""
    pp = prior_sidecar_path(path)
    if os.path.exists(pp) and not _sentinel_in_keys(pp, _PRIOR_SENTINEL):
        raise ValueError(
            f"{pp} exists and is not a prior sidecar (a checkpoint named "
            f"with the reserved '.prior' suffix?); refusing to overwrite")
    save_checkpoint(pp, {"prior": prior, _PRIOR_SENTINEL: np.int8(1)},
                    config_json=config_json)
    return pp


def load_prior_sidecar(path: str, template_grid: Any,
                       running_config_json: Optional[str] = None) -> Any:
    """`path`'s prior sidecar, or None when there is none. ValueError on
    a non-sidecar file, shape drift or config drift."""
    pp = prior_sidecar_path(path)
    if not os.path.exists(pp):
        return None
    if not _sentinel_in_keys(pp, _PRIOR_SENTINEL):
        raise ValueError(
            f"{pp} is not a prior sidecar (name collision with a "
            f"checkpoint named '.prior'?); refusing to load")
    state, cfg_json = load_checkpoint(
        pp, {"prior": template_grid, _PRIOR_SENTINEL: np.int8(0)})
    _check_config("prior", cfg_json, running_config_json)
    return state["prior"]


def clear_prior_sidecar(path: str) -> bool:
    """Remove `path`'s .prior sidecar if there is one; returns whether a
    file was removed. A non-sidecar file at that name is left alone."""
    pp = prior_sidecar_path(path)
    if os.path.exists(pp) and _sentinel_in_keys(pp, _PRIOR_SENTINEL):
        os.unlink(pp)
        return True
    return False


def keyframe_sidecar_path(path: str) -> str:
    """The depth-keyframe ring's sidecar next to a 2D checkpoint (its
    arrays are variable-length, so it is not a template-checked
    checkpoint)."""
    root, ext = os.path.splitext(path)
    return root + ".voxelkf" + (ext or ".npz")


_KF_KEYS = ("depths", "rels", "node_idx", "thins", "robot")


def save_keyframe_sidecar(path: str, kf: dict,
                          config_json: Optional[str] = None) -> str:
    """Write a keyframe ring (a dict of the `_KF_KEYS` arrays) as
    `path`'s .voxelkf sidecar; returns the sidecar path."""
    missing = [k for k in _KF_KEYS if k not in kf]
    if missing:
        raise ValueError(f"keyframe snapshot missing keys {missing}")
    kp = keyframe_sidecar_path(path)
    if os.path.exists(kp) and not _meta_kind_is(kp, "voxel_keyframes"):
        raise ValueError(
            f"{kp} exists and is not a keyframe sidecar (a checkpoint "
            f"named with the reserved '.voxelkf' suffix?); refusing to "
            f"overwrite")
    meta = {"config": config_json, "version": 1, "kind": "voxel_keyframes"}
    arrays = {k: _to_numpy(kf[k]) for k in _KF_KEYS}
    arrays[_META_KEY] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    tmp = kp + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
    os.replace(tmp, kp)
    return kp


def load_keyframe_sidecar(path: str,
                          running_config_json: Optional[str] = None):
    """`path`'s keyframe ring as a dict of numpy arrays, or None when
    there is none. ValueError on a wrong-kind file, config drift, missing
    arrays or arrays of different lengths."""
    kp = keyframe_sidecar_path(path)
    if not os.path.exists(kp):
        return None
    with np.load(kp) as z:
        try:
            meta = json.loads(bytes(z[_META_KEY].tobytes()).decode())
        except Exception:                    # noqa: BLE001
            meta = {}
        if meta.get("kind") != "voxel_keyframes":
            raise ValueError(
                f"{kp} is not a voxel keyframe sidecar; refusing to load")
        _check_config("keyframe", meta.get("config"), running_config_json)
        absent = [k for k in _KF_KEYS if k not in z.files]
        if absent:
            raise ValueError(
                f"keyframe sidecar {kp} missing arrays {absent}")
        out = {k: z[k] for k in _KF_KEYS}
    lens = {k: len(out[k]) for k in _KF_KEYS}
    if len(set(lens.values())) != 1:
        raise ValueError(
            f"keyframe sidecar arrays disagree on length: {lens}")
    return out


def world_sidecar_path(path: str) -> str:
    """The bounded-memory world's window manifest next to a 2D
    checkpoint (`WorldStore.checkpoint_payload`): window origin, epochs,
    away-set, and the host tiles when the store has no disk tier."""
    root, ext = os.path.splitext(path)
    return root + ".world" + (ext or ".npz")


#: Arrays every world payload carries; host_meta / host_tiles only when
#: the store has no disk tier.
_WORLD_KEYS = ("origin_tile", "epochs", "away")


def save_world_sidecar(path: str, payload: dict,
                       config_json: Optional[str] = None) -> str:
    """Write a `WorldStore.checkpoint_payload()` as `path`'s .world
    sidecar, each array with its CRC32; returns the sidecar path. The
    same clobber guard as the other sidecars."""
    missing = [k for k in _WORLD_KEYS if k not in payload]
    if missing:
        raise ValueError(f"world payload missing keys {missing}")
    wp = world_sidecar_path(path)
    if os.path.exists(wp) and not _meta_kind_is(wp, "world_window"):
        raise ValueError(
            f"{wp} exists and is not a world sidecar (a checkpoint named "
            f"with the reserved '.world' suffix?); refusing to overwrite")
    arrays = {k: np.asarray(v) for k, v in payload.items()}
    meta = {"config": config_json, "version": 1, "kind": "world_window",
            "keys": sorted(arrays),
            "crc32": {k: _leaf_crc(v) for k, v in arrays.items()}}
    arrays[_META_KEY] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    tmp = wp + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
    os.replace(tmp, wp)
    return wp


def load_world_sidecar(path: str,
                       running_config_json: Optional[str] = None):
    """`path`'s world sidecar as a dict of arrays, or None when there is
    none (the window then starts at its anchor). ValueError on a
    wrong-kind file or config drift; CheckpointCorrupt on an unreadable
    file or a CRC failure."""
    wp = world_sidecar_path(path)
    if not os.path.exists(wp):
        return None
    try:
        with np.load(wp) as z:
            meta = json.loads(bytes(z[_META_KEY].tobytes()).decode())
            if meta.get("kind") != "world_window":
                raise ValueError(
                    f"{wp} is not a world sidecar; refusing to load")
            out = {k: z[k] for k in meta["keys"]}
    except (OSError, KeyError, json.JSONDecodeError, zipfile.BadZipFile,
            zlib.error) as e:
        raise CheckpointCorrupt(
            f"world sidecar {wp} is unreadable "
            f"({type(e).__name__}: {e})") from e
    crcs = meta.get("crc32", {})
    bad = [k for k, v in out.items()
           if k in crcs and _leaf_crc(v) != crcs[k]]
    if bad:
        raise CheckpointCorrupt(
            f"world sidecar {wp} failed CRC32 verification on "
            f"arrays {bad} — corrupted on disk")
    missing = [k for k in _WORLD_KEYS if k not in out]
    if missing:
        raise ValueError(f"world sidecar {wp} missing arrays {missing}")
    _check_config("world", meta.get("config"), running_config_json)
    return out


def clear_world_sidecar(path: str) -> bool:
    """Remove `path`'s .world sidecar if there is one (a save from an
    unwindowed stack clears a stale manifest); a non-sidecar file at
    that name is left alone."""
    wp = world_sidecar_path(path)
    if os.path.exists(wp) and _meta_kind_is(wp, "world_window"):
        os.unlink(wp)
        return True
    return False


def checkpoint_bytes(state: Any, config_json: Optional[str] = None) -> bytes:
    """In-memory variant of `save_checkpoint` (for shipping state over a
    wire): the same keys and meta record as the JAX package's, without
    the per-leaf CRCs, as one `.npz` byte string."""
    buf = io.BytesIO()
    arrays = {key: _to_numpy(leaf) for key, leaf in _flatten(state)}
    meta = {"keys": list(arrays.keys()), "config": config_json, "version": 1}
    arrays[_META_KEY] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()
