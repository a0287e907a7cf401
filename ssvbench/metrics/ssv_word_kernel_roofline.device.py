"""``ssv_word_kernel_roofline``, in the cells where the end-to-end metric
that it moves is the device's time a search: the same reading, from the
same reader."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "ssvbench_metric_ssv_word_kernel_roofline_base",
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 "ssv_word_kernel_roofline.py"))
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)
read = _base.read
