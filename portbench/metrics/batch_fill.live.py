"""Mean frames per feature batch over the batch size, from the feature
control plane's report of the window's ``run_stream_async``."""


def read(ctx):
    report = ctx.get("control_plane")
    if not report:
        return None
    feature = report["snapshots"]["feature"]
    size = ctx["cell"].traffic.get("feature_control", {}).get("batch_size", 4)
    if not feature.get("batches"):
        return None
    return feature["mean_batch_fill"] / size
