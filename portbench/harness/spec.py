"""``BENCHMARK.json`` and the data files it names, found by name.

Everything that belongs to one configuration, one traffic mix, one cell's
limits or one per-layer metric is a file of its own under the checkout's
``portbench/`` folder, so a cell or a metric is added by adding files and
entries, never by editing one:

* ``configs/<config>.json``: the file that ``BENCHMARK.json``'s
  configuration entry names (``scene``, ``scene_args``, ``pack``);
* ``scenes/<scene>.py``: a scene builder, ``build(**scene_args)`` -> dict
  of numpy arrays;
* ``traffic/<traffic>.json``: the render request and the check's sample;
* ``limits/<workload>.json``: each compared number's limit;
* ``metrics/<metric>.py``: a reader, ``read(ctx)`` -> float or None.
"""

from __future__ import annotations

import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class Spec:
    """The benchmark of the checkout at ``root``."""

    def __init__(self, root: str = ROOT):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.bench = json.load(f)
        self.dir = os.path.join(root, "portbench")

    def _json(self, *parts):
        with open(os.path.join(self.dir, *parts)) as f:
            return json.load(f)

    def _module(self, kind: str, name: str):
        path = os.path.join(self.dir, kind, name + ".py")
        spec = importlib.util.spec_from_file_location(
            f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}",
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name + ".json")

    def limits(self, workload: str) -> dict:
        return self._json("limits", workload + ".json")

    def scene(self, config: dict) -> dict:
        """The configuration's scene arrays."""
        return self._module("scenes", config["scene"]).build(
            **config.get("scene_args", {}))

    def end_to_end(self, workload: str) -> list:
        return [m for m in self.bench["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> list:
        return [m for m in self.bench["per_layer"]
                if workload in m.get("workloads", [workload])]

    def reader(self, metric: str):
        return self._module("metrics", metric).read
