from .models import ScaramuzzaCamera, camera_from_dict, camera_from_yaml
