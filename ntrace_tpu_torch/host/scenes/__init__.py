from ntrace_tpu_torch.host.scenes.procedural import (  # noqa: F401
    SCENE_REGISTRY,
    default_camera,
    get_scene,
    make_conference,
    make_fairy_forest,
    make_hairball,
    make_random_soup,
    make_san_miguel,
    make_sibenik,
    make_single_triangle,
    make_two_quads,
)
