"""The SLAMSystem entry point and the fused tracking step (port of
``mvslam_tpu.slam``; the reference's four public names)."""

from mvslam_tpu_torch.slam.api import (
    FrameDiagnostics,
    SLAMRunResult,
    SLAMSystem,
    SLAMSystemConfig,
)

__all__ = ["SLAMSystem", "SLAMSystemConfig", "SLAMRunResult", "FrameDiagnostics"]
