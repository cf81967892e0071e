"""ms a frame that the stream's launches blocked for a free slot:
``StereoServer.stats()``'s ``slot_wait_s`` over its ``frames``, over the
whole run (warm-up, window and profiled sub-windows). None for a program
whose server keeps no such counter."""


def read(ctx):
    server = getattr(ctx.sut, "server", None)
    stats = server.stats() if server is not None else {}
    if "slot_wait_s" not in stats or not stats.get("frames"):
        return None
    return 1e3 * stats["slot_wait_s"] / stats["frames"]
