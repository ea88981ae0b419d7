from pose_refine.utils.timer import Timer, time_jitted  # noqa: F401
