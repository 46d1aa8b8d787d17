from tcct_tpu_torch.data.geometry import GEOMETRY, DatasetGeometry, get_geometry
from tcct_tpu_torch.data.eyeset import EyeSet, postprocess, prep, synthesize_oct
from tcct_tpu_torch.data.augment import apply_train, apply_val, draw_train, draw_val
