from .paper_apps import (
    ALL_APPS,
    build_camera,
    build_gaussian,
    build_harris,
    build_mobilenet,
    build_resnet,
    build_unsharp,
    build_upsample,
    make_app,
)

__all__ = [
    "ALL_APPS",
    "build_camera",
    "build_gaussian",
    "build_harris",
    "build_mobilenet",
    "build_resnet",
    "build_unsharp",
    "build_upsample",
    "make_app",
]
