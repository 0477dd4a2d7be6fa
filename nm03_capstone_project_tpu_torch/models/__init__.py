"""The learned model family: U-Net students distilled from the pipeline.

The port of the JAX package's ``models/``: the 2D and 3D students, their
distillation training on one device, the 2D student's data x tensor
parallel training over a mesh (``param_shardings``,
``make_sharded_train_step``, ``fit_sharded``) and across the ranks of a
job (``fit_distributed``, ``pad_local_shard``), and the port's
checkpoints.
"""

from nm03_capstone_project_tpu_torch.models.checkpoint import (  # noqa: F401
    load_params,
    save_params,
)
from nm03_capstone_project_tpu_torch.models.train import (  # noqa: F401
    distill_batch,
    fit,
    fit_distributed,
    fit_sharded,
    make_optimizer,
    make_sharded_train_step,
    pad_local_shard,
    prepare_student_inputs,
    segmentation_loss,
    train_step,
)
from nm03_capstone_project_tpu_torch.models.unet import (  # noqa: F401
    UNet,
    apply_unet,
    init_unet,
    param_shardings,
    predict_mask,
)
from nm03_capstone_project_tpu_torch.models.unet3d import (  # noqa: F401
    UNet3d,
    apply_unet3d,
    distill_volume,
    init_unet3d,
    predict_mask3d,
)
