"""Locate the built native cores (``native/*.so``: the host-side data cores,
C++ bound with ctypes; own copy of mobilesuperresolution_tpu/core/native_path.py).

Search order:

1. ``$MSR_NATIVE_DIR``, an explicit override (wheel installs, system
   packages);
2. ``<repo>/native/`` next to the package, the source-checkout layout, where
   ``make -C native`` puts the libraries (they are committed there);
3. ``mobilesuperresolution_tpu_torch/_native/`` inside the package, for
   distributions that copy the built libraries into the package tree.

Every native entry point keeps its numpy path, bit-identical, which runs
where a library is missing: a missing library costs host time, never
correctness.
"""

import logging
import os

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
log = logging.getLogger("msr_torch.native")


def find_native_lib(name):
    """The path to ``name`` (e.g. ``libloader.so``), or None."""
    env = os.environ.get("MSR_NATIVE_DIR")
    candidates = [os.path.join(env, name)] if env else []
    candidates.append(os.path.join(os.path.dirname(_PKG_DIR), "native", name))
    candidates.append(os.path.join(_PKG_DIR, "_native", name))
    for path in candidates:
        if os.path.exists(path):
            return path
    return None


def load_native_lib(name):
    """``ctypes.CDLL`` of ``name``, or None where it is missing or does not
    load; either way one log line names the path taken."""
    import ctypes

    path = find_native_lib(name)
    if path is not None:
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            log.warning(f"native core {name} at {path} does not load ({e}): numpy path")
            return None
        log.info(f"native core {name}: {path}")
        return lib
    log.info(f"native core {name} not found (MSR_NATIVE_DIR, <repo>/native, the package's _native): numpy path")
    return None
