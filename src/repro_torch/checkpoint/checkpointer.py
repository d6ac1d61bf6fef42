"""Fault-tolerant checkpointing (port of ``repro.checkpoint.checkpointer``,
with its API and its on-disk format, so files pass between the two
packages in both directions).

Versioned step directories ``step_%08d``, written into a temporary
directory and committed by an atomic rename; a content digest in
``meta.json``; an asynchronous save thread; resume from the latest step;
the ``keep`` newest steps kept.

A tree is nested dicts of numpy arrays (the reference's pytree form:
``interop.arrays_from_params`` makes it from a model's or a moment's state
dict). Each tree is one ``.npz`` flattened by ``/``-joined keys; a bf16
leaf (:class:`interop.BF16Bits`) is stored as its ``uint16`` bits under
``key::bf16``, as the reference stores its bf16 arrays. No ``ml_dtypes``
is needed: bf16 moves through ``torch`` views.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.interop import BF16Bits, bf16_bits, bits_of, torch_from_bits


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    if isinstance(tree, Mapping):
        for k in tree:
            flat.update(_flatten(tree[k], f"{prefix}{k}/"))
        return flat
    key = prefix[:-1]
    if isinstance(tree, BF16Bits):
        flat[key + "::bf16"] = tree.view(np.ndarray)
    else:
        flat[key] = np.asarray(tree)
    return flat


def _digest(flat: Dict[str, np.ndarray]) -> str:
    h = hashlib.sha256()
    for k in sorted(flat):
        h.update(k.encode())
        h.update(np.ascontiguousarray(flat[k]).tobytes()[:65536])
    return h.hexdigest()[:16]


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save ----
    def save(self, step: int, params: Any, opt_state: Any = None,
             metadata: Optional[Dict] = None, block: bool = False) -> None:
        """Write ``params`` (and ``opt_state``) as step ``step``: on a
        thread unless ``block`` or ``async_save=False``. The trees must
        already be on the host; a failed write raises at the next
        ``save`` or ``wait``."""
        flat_p = _flatten(params)
        flat_o = _flatten(opt_state) if opt_state is not None else {}
        meta = dict(metadata or {})
        meta["step"] = int(step)
        meta["time"] = time.time()

        def _write():
            # a unique temporary directory: a blocking save may overlap a
            # still-running asynchronous save of the same step
            tmp = os.path.join(self.dir,
                               f".tmp_step_{step}_{time.monotonic_ns()}")
            final = os.path.join(self.dir, f"step_{step:08d}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "params.npz"), **flat_p)
            if flat_o:
                np.savez(os.path.join(tmp, "opt_state.npz"), **flat_o)
            meta["params_digest"] = _digest(flat_p)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # commit point: atomic
            self._gc()

        def _write_reporting():
            try:
                _write()
            except Exception as exc:  # raised again by wait()
                self._error = exc

        self.wait()  # serialize with any in-flight asynchronous save
        if self.async_save and not block:
            self._thread = threading.Thread(target=_write_reporting,
                                            daemon=True)
            self._thread.start()
        else:
            _write()

    def wait(self) -> None:
        """Join the asynchronous save, and raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore ----
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int], params_like: Any,
                opt_like: Any = None) -> Tuple[Any, Any, Dict]:
        """Restore into the structure of ``params_like`` (and
        ``opt_like``): each leaf takes the like leaf's shape (checked) and
        dtype. ``step=None`` is the latest step."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(d, "params.npz")) as z:
            flat_p = dict(z)
        if (meta.get("params_digest")
                and _digest(flat_p) != meta["params_digest"]):
            raise IOError(f"checkpoint step {step}: params digest mismatch")
        params = _unflatten_like(params_like, flat_p)
        opt_state = None
        path = os.path.join(d, "opt_state.npz")
        if opt_like is not None and os.path.exists(path):
            with np.load(path) as z:
                opt_state = _unflatten_like(opt_like, dict(z))
        return params, opt_state, meta


def _cast(arr: np.ndarray, bf16: bool, like: Any) -> np.ndarray:
    """``arr`` (bf16 bits when ``bf16``) in the like leaf's dtype."""
    if isinstance(like, BF16Bits):
        if bf16:
            return bf16_bits(arr)
        return bits_of(torch.from_numpy(np.asarray(arr)).to(torch.bfloat16))
    dtype = np.asarray(like).dtype
    if bf16:
        # a CPU tensor, read from the file: nothing waits for a card
        f32 = torch_from_bits(arr).float().numpy()  # host-sync: ok
        return f32.astype(dtype)
    return np.asarray(arr).astype(dtype)


def _unflatten_like(like: Any, flat: Dict[str, np.ndarray],
                    prefix: str = "") -> Any:
    if isinstance(like, Mapping):
        return {k: _unflatten_like(v, flat, f"{prefix}{k}/")
                for k, v in like.items()}
    key = prefix[:-1]
    if key + "::bf16" in flat:
        arr, bf16 = flat[key + "::bf16"], True
    elif key in flat:
        arr, bf16 = flat[key], False
    else:
        raise KeyError(f"checkpoint missing {key}")
    shape = tuple(np.shape(like))
    if tuple(arr.shape) != shape:
        raise ValueError(f"{key}: shape {arr.shape} != expected {shape}")
    return _cast(arr, bf16, like)
