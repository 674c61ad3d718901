"""Run directory: stage artifacts + manifest = the checkpoint/resume system.
A copy of allpathslg_tpu/pipeline/rundir.py (host numpy, no framework).

The reference's checkpointing IS its Makefile DAG over complete-on-rename
binary files (ref: RunAllPathsLG generated Makefile, SURVEY.md §5.4). Here:
a run directory holds one .npz per named artifact plus `manifest.json`
mapping each completed stage to its input hash, outputs and metrics; the
runner skips stages whose inputs are unchanged and outputs present.
Writes go through a temp file + rename so interrupted stages never leave
half-written artifacts.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np

from allpathslg_tpu_torch import trace


class RunDir:
    def __init__(self, path: str):
        import threading
        self.path = path
        os.makedirs(path, exist_ok=True)
        self.manifest_path = os.path.join(path, "manifest.json")
        self.manifest: Dict = {"stages": {}, "created": time.time()}
        self._manifest_lock = threading.Lock()
        if os.path.exists(self.manifest_path):
            with open(self.manifest_path) as f:
                self.manifest = json.load(f)

    # ---- artifacts ----
    # Two on-disk forms, switched by size (transparent to callers):
    #   <name>.npz       small artifacts, one file
    #   <name>.arrd/     large artifacts: one raw .npy per array — the
    #                    out-of-core form; load_arrays(mmap=True) returns
    #                    np.memmap views so consumers page rows on demand
    #                    (ref: feudal/VirtualMasterVec.h lazy file-backed
    #                    access, SURVEY.md §2.1)
    BIG_BYTES = 64 << 20

    def _file(self, name: str) -> str:
        return os.path.join(self.path, name + ".npz")

    def _dir(self, name: str) -> str:
        return os.path.join(self.path, name + ".arrd")

    def save_arrays(self, name: str, **arrays) -> str:
        # uncompressed: base-code arrays are hundreds of MB at genome scale
        # and zlib costs minutes of host CPU per stage (ref analog: raw
        # feudal binary files, not compressed)
        arrays = {k: np.asarray(v) for k, v in arrays.items()}
        total = sum(a.nbytes for a in arrays.values())
        with trace.span("artifact.save", run=self.path, artifact=name) as sp:
            sp.add("bytes", total)
            if total >= self.BIG_BYTES:
                return self._save_dir(name, arrays)
            tmp = self._file(name) + ".tmp"
            with open(tmp, "wb") as fh:
                np.savez(fh, **arrays)
            os.replace(tmp, self._file(name))
            if os.path.isdir(self._dir(name)):  # stale big form of same name
                import shutil
                shutil.rmtree(self._dir(name), ignore_errors=True)
            return self._file(name)

    def _save_dir(self, name: str, arrays: Dict[str, np.ndarray]) -> str:
        import shutil
        d = self._dir(name)
        tmp = d + ".tmp"
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for k, a in arrays.items():
            np.save(os.path.join(tmp, k + ".npy"), a)
        if os.path.isdir(d):
            shutil.rmtree(d)
        os.replace(tmp, d)
        if os.path.exists(self._file(name)):  # stale small form
            os.remove(self._file(name))
        return d

    def load_arrays(self, name: str, mmap: bool = False
                    ) -> Dict[str, np.ndarray]:
        """mmap=True: large (.arrd) artifacts come back as read-only
        np.memmap views — rows page in on demand (VirtualMasterVec analog).
        npz artifacts always load eagerly (zip members cannot be mapped).
        The span `artifact.load` covers the read, or the open only of
        mapped arrays (whose bytes count as `mapped`, not `bytes`)."""
        with trace.span("artifact.load", run=self.path, artifact=name) as sp:
            d = self._dir(name)
            if os.path.isdir(d):
                out = {}
                for fn in sorted(os.listdir(d)):
                    if fn.endswith(".npy"):
                        out[fn[:-4]] = np.load(os.path.join(d, fn),
                                               mmap_mode="r" if mmap else None)
                sp.add("mapped" if mmap else "bytes",
                       sum(a.nbytes for a in out.values()))
                return out
            with np.load(self._file(name)) as z:
                out = {k: z[k] for k in z.files}
            sp.add("bytes", sum(a.nbytes for a in out.values()))
            return out

    def has(self, name: str) -> bool:
        return os.path.exists(self._file(name)) or os.path.isdir(self._dir(name))

    def fingerprint(self, name: str) -> str:
        """Cheap artifact fingerprint: file sizes + mtimes (both forms)."""
        p = self._file(name)
        if os.path.exists(p):
            s = os.stat(p)
            return f"{s.st_size}:{int(s.st_mtime)}"
        d = self._dir(name)
        if os.path.isdir(d):
            parts = []
            for fn in sorted(os.listdir(d)):
                s = os.stat(os.path.join(d, fn))
                parts.append(f"{fn}={s.st_size}:{int(s.st_mtime)}")
            return ";".join(parts)
        return "missing"

    def file_path(self, name: str) -> str:
        return os.path.join(self.path, name)

    # ---- stage bookkeeping ----
    @staticmethod
    def hash_of(*parts) -> str:
        h = hashlib.sha1()
        for p in parts:
            if isinstance(p, np.ndarray):
                h.update(p.tobytes())
            else:
                h.update(str(p).encode())
        return h.hexdigest()[:16]

    def _output_present(self, o: str) -> bool:
        if os.path.exists(os.path.join(self.path, o)):
            return True
        # an .npz-named output may exist in the big (.arrd) form instead
        if o.endswith(".npz"):
            return os.path.isdir(os.path.join(self.path, o[:-4] + ".arrd"))
        return False

    def stage_done(self, stage: str, inputs_hash: str, outputs: List[str]) -> bool:
        rec = self.manifest["stages"].get(stage)
        if rec is None or rec.get("inputs_hash") != inputs_hash:
            return False
        return all(self._output_present(o) for o in rec["outputs"])

    def mark_done(self, stage: str, inputs_hash: str, outputs: List[str],
                  metrics: Optional[Dict] = None, elapsed: float = 0.0):
        # lock: concurrent DAG stages (stage_workers > 1) mark_done from
        # different threads; the manifest write must be atomic per update
        with self._manifest_lock:
            self.manifest["stages"][stage] = {
                "inputs_hash": inputs_hash,
                "outputs": outputs,
                "metrics": metrics or {},
                "elapsed_s": round(elapsed, 3),
                "finished": time.time(),
            }
            tmp = self.manifest_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self.manifest, f, indent=1)
            os.replace(tmp, self.manifest_path)

    def metrics(self, stage: str) -> Dict:
        rec = self.manifest["stages"].get(stage) or {}
        return rec.get("metrics", {})
