from sound_bubble_tpu_torch.models.tfgridnet.model import Net, NetConfig  # noqa: F401
