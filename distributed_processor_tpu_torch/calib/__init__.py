"""Gradient-based calibration service (docs/CALIBRATION.md).

The closed-loop tuning vertical: differentiable forward models live in
:mod:`..sim.grad`, the serve-tier traffic class in :mod:`.session`
(opened via ``ExecutionService.open_calibration``), and the
gradient-descent loops — candidate submission, convergence detection,
live-qchip writeback, stale-epoch flush — in :mod:`.loops`.
"""

from .loops import CalibResult, calibrate
from .session import CalibrationSession
