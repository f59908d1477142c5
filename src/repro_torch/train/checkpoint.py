"""Checkpoint save/restore for fault-tolerant training: the port of the JAX
package's ``train/checkpoint.py``.

- atomic: written to ``step_N.tmp/``, then renamed; a crash mid-save never
  corrupts the latest checkpoint;
- retention: the newest ``keep`` checkpoints stay;
- async: ``save_async`` copies the tensors to the host on the caller's
  thread and writes them from a worker thread, so the train loop waits for
  one device-to-host copy;
- restore: ``latest_step`` + ``restore`` rebuild the param and optimizer
  trees, and the train loop resumes from the last durable step.

Format: one ``.npz`` per tree (params, optimizer state) and a JSON
manifest with the step and each tree's names. The port's trees are flat
dicts of dotted names (the optimizer state's moments under ``m.`` and
``v.``), so the names are the structure. numpy has no bfloat16: a bf16
leaf is stored as fp32 (exactly) and cast back on restore.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch


def _flatten(tree: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _to_host(tree: dict) -> dict[str, np.ndarray]:
    """A copy of every leaf on the host (never a view of a live tensor)."""
    def one(t: torch.Tensor) -> np.ndarray:
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()

    return {k: one(v) for k, v in _flatten(tree).items()}


class CheckpointManager:
    def __init__(self, directory: str | pathlib.Path, keep: int = 3,
                 shard_id: int = 0):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.shard_id = shard_id
        self._thread: Optional[threading.Thread] = None
        self.save_seconds = 0.0

    # ------------------------------------------------------------------ save
    def save(self, step: int, params: dict, opt_state: dict,
             extra: dict | None = None):
        t0 = time.time()
        self._write(step, _to_host(params), _to_host(opt_state), extra or {})
        self.save_seconds += time.time() - t0

    def save_async(self, step: int, params: dict, opt_state: dict,
                   extra: dict | None = None):
        """Snapshot on the caller's thread (device to host), write in the
        background."""
        self.wait()
        host_params, host_opt = _to_host(params), _to_host(opt_state)
        self._thread = threading.Thread(
            target=self._write, args=(step, host_params, host_opt,
                                      extra or {}), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, params: dict, opt_state: dict, extra: dict):
        tmp = self.dir / f"step_{step:010d}.tmp"
        final = self.dir / f"step_{step:010d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        np.savez(tmp / f"params_{self.shard_id}.npz", **params)
        np.savez(tmp / f"opt_{self.shard_id}.npz", **opt_state)
        (tmp / "manifest.json").write_text(json.dumps(
            {"step": step, "time": time.time(), "params": sorted(params),
             "opt": sorted(opt_state), **extra}))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                                   # atomic publish
        self._retain()

    def _retain(self):
        ckpts = sorted(self.dir.glob("step_*"))
        ckpts = [c for c in ckpts if not c.name.endswith(".tmp")]
        for old in ckpts[:-self.keep]:
            shutil.rmtree(old)

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        ckpts = sorted(self.dir.glob("step_*"))
        ckpts = [c for c in ckpts if not c.name.endswith(".tmp")
                 and (c / "manifest.json").exists()]
        if not ckpts:
            return None
        return json.loads((ckpts[-1] / "manifest.json").read_text())["step"]

    def restore(self, step: int, params_like: dict, opt_like: dict):
        """New trees shaped like the given ones, each leaf on its device
        and in its dtype. Returns (params, opt_state, manifest)."""
        d = self.dir / f"step_{step:010d}"
        manifest = json.loads((d / "manifest.json").read_text())

        def rebuild(like: dict, npz, names: list[str], prefix: str = ""):
            out = {}
            for k, v in like.items():
                if isinstance(v, dict):
                    out[k] = rebuild(v, npz, names, f"{prefix}{k}.")
                    continue
                name = prefix + k
                if name not in names:
                    raise KeyError(f"checkpoint step {step} has no {name!r}")
                out[k] = torch.from_numpy(npz[name]).to(v.device, v.dtype)
            return out

        with np.load(d / f"params_{self.shard_id}.npz") as p_npz, \
                np.load(d / f"opt_{self.shard_id}.npz") as o_npz:
            return (rebuild(params_like, p_npz, manifest["params"]),
                    rebuild(opt_like, o_npz, manifest["opt"]), manifest)
