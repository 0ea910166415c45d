"""Share of window BA's solves that replayed as a captured CUDA graph, as a
ratio: the ``ba_graph_replay`` spans over the ``ba_solve`` spans of the
window outside its traced stretch. None where there is no ``ba_solve``
span; a program without BA's graph cache records no replay and reads 0."""


def read(ctx):
    names = [n for n, _, _ in ctx["spans"]]
    solves = names.count("ba_solve")
    return names.count("ba_graph_replay") / solves if solves else None
