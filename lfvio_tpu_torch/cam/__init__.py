from .models import (
    KannalaBrandtCamera,
    MeiCamera,
    PinholeCamera,
    ScaramuzzaCamera,
    camera_from_dict,
    camera_from_yaml,
)
