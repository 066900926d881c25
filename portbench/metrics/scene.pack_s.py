"""scene.pack_s: host seconds of ``pack_scene`` and ``pack_camera`` on the
card until the tables are resident (a synchronise). Layer: scene. Moves
setup_s."""


def read(ctx):
    return ctx["pack_s"]
