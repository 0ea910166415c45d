"""Share of the tracking step's calls whose match and pose stages replayed
as captured CUDA graphs, as a ratio: the ``pair_graph_replay`` spans over
the ``pose.device`` spans (one of each per tracking call: a window
offline, a frame live) of the window outside its traced stretch. None
where there is no ``pose.device`` span, or where the program has no graph
cache (``mvslam_tpu_torch/slam/pair_graphs.py``) to record a replay."""

import importlib.util


def read(ctx):
    names = [n for n, _, _ in ctx["spans"]]
    poses = names.count("pose.device")
    if not poses or importlib.util.find_spec("mvslam_tpu_torch.slam.pair_graphs") is None:
        return None
    return names.count("pair_graph_replay") / poses
