"""Visualization and dashboards: the live path animator, the matplotlib viewer,
the web dashboard server and the launcher.

Port of ``mvslam_tpu/viz/``: numpy host code, copied close to verbatim;
matplotlib and ``websockets`` are imported only where they are used.
"""
