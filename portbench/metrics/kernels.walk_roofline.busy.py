"""kernels.walk_roofline.busy: kernels.walk_roofline, in the cells that
report busy_ms: % of the walk kernels' device time that the traced
frames' ray queries need at the least (the packet walks' closest-hit and
any-hit instances where a scene takes the packet route). Layer: kernels.
Moves busy_ms. Read by kernels.walk_roofline's own reader."""

import importlib.util
import os

_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "kernels.walk_roofline.py")
_spec = importlib.util.spec_from_file_location(
    "portbench_metrics_kernels_walk_roofline", _path)
_roofline = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_roofline)
read = _roofline.read
