"""Profiler capture around the device regions: `--profile-dir DIR`.

Counterpart of `abpoa_tpu/obs/capture.py`, on `torch.profiler` instead of
`jax.profiler`. `set_profile_dir` arms a process-global directory; the
drivers bracket their device region with `device_capture(label)`. The
outermost bracket starts one `torch.profiler.profile` with CPU activity
(and CUDA activity where a card is present: the CUPTI trace of every
kernel, the ctypes-launched ones included) and, on exit, exports it as a
Chrome trace `<label>.<pid>.<n>.pt.trace.json` into the directory; inner
brackets add a `record_function(label)` range to the running capture.

Nothing here is swallowed: a profiler that fails to start or export when
the user asked for a capture raises (the JAX package's hooks degrade to a
no-op instead). Unarmed (the default), a bracket is one attribute check.
"""
from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

_PROFILE_DIR: Optional[str] = None
_ACTIVE = False  # a capture is running (one at a time, like the JAX hooks)
_EXPORTED = 0


def set_profile_dir(path: Optional[str]) -> None:
    global _PROFILE_DIR
    if path:
        os.makedirs(path, exist_ok=True)
    _PROFILE_DIR = path or None


def profile_dir() -> Optional[str]:
    return _PROFILE_DIR


def _activities() -> list:
    import torch
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def device_capture(label: str) -> Iterator[None]:
    """Capture bracket for a device region: the outermost one profiles
    into the armed directory, inner ones add a labelled range."""
    global _ACTIVE, _EXPORTED
    d = _PROFILE_DIR
    if d is None:
        yield
        return
    import torch
    if _ACTIVE:
        with torch.profiler.record_function(label):
            yield
        return
    prof = torch.profiler.profile(activities=_activities())
    prof.__enter__()
    _ACTIVE = True
    try:
        with torch.profiler.record_function(label):
            yield
    finally:
        _ACTIVE = False
        prof.__exit__(None, None, None)
    _EXPORTED += 1
    prof.export_chrome_trace(os.path.join(
        d, f"{label}.{os.getpid()}.{_EXPORTED}.pt.trace.json"))
