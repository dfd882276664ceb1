"""Device idle ms a frame under the frame loop's own spans: the rays,
the image's assembly from the chunks and its copy to the host."""

from nerfbench import spans

LAYER = "frame loop"
UNIT = "ms"
MOVES = "render_rays_per_s"


def read(traced):
    return spans.per_frame_ms(traced, spans.FRAME, idle=True)
