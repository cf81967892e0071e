"""Device ms of one call into a layer at the cell's bucket or crop: CUDA
events around a run of calls made after the window (the harness's
``layer_ms``): ``features`` is ``StereoServer.features`` or
``Trainer.features``, ``regularizer`` is ``StereoServer.model`` over that
feature volume."""


def read(ctx, layer: str):
    return ctx.layer_ms(layer)
