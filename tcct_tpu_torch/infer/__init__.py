from tcct_tpu_torch.infer.export import (
    export_model,
    load_exported,
    load_params_npz,
    save_params_npz,
)
from tcct_tpu_torch.infer.importer import from_jax_variables, load_into, load_reference_pt
from tcct_tpu_torch.infer.predictor import VolumePredictor, load_predictor
