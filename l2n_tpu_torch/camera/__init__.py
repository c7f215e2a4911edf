"""Camera layer: uniforms, FPS view controller, JSON pose persistence."""

from l2n_tpu_torch.camera.camera import Camera  # noqa: F401
from l2n_tpu_torch.camera.view_controller import ViewController, ControllerInput  # noqa: F401
from l2n_tpu_torch.camera.cache import load_view_matrix, save_view_matrix  # noqa: F401
