"""scene_load_s: seconds of set-up spent loading the scene (the table cache's
read on a warm checkout, the generation and build on a cold one), on the host
clock between synchronizations.  Moves setup_s."""


def read(ctx):
    return ctx["scene_load_s"]
