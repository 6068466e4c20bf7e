"""portbench: the benchmark of the PyTorch and CUDA port (``bvh_tpu_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON line. Everything that belongs to one configuration,
traffic mix, cell or metric is a file of its own, found by the name that
``BENCHMARK.json`` or another file gives it:

* ``configs/<config>.json``: the scene, its maker and the build;
* ``scenes/<maker>.py``: a scene maker, ``make(**args) -> (a, b, c)``,
  and ``SMALL``, the args of a scene the CPU tests run in a second;
* ``traffic/<mix>.json``: a traffic mix's parameters;
* ``kinds/<kind>.py``: a part of a mix, ``make(n, g, part, ctx)``, which
  returns the part's per-row arrays;
* ``entries/<kind>.py``: the program's timed call, with the reference and
  the comparison that judge its answers;
* ``cells/<cell>.json``: a cell's limits;
* ``layers/<reader>.py``: a per-layer metric's reader (``harness.reader``).
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

_LOADED: dict = {}


def plugin(root: Path, folder: str, name: str):
    """The module ``root/portbench/<folder>/<name>.py``, loaded once."""
    path = Path(root) / "portbench" / folder / f"{name}.py"
    if path not in _LOADED:
        if not path.is_file():
            raise FileNotFoundError(f"portbench: no {path}")
        tag = f"portbench_{folder}_{name}".replace(".", "_")
        spec = importlib.util.spec_from_file_location(tag, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]
