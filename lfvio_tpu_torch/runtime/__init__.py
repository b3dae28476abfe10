from .feature_manager import HostFeatureManager
from .tracker import FrontEnd
from .estimator import Estimator, EstimatorConfig
from .pipeline import VioPipeline
from .trajectory_io import write_tum, read_tum
from .evaluation import ate_rmse, align_umeyama
