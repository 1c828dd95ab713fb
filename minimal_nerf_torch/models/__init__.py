"""The NeRF MLP and the hierarchical coarse + fine network."""

from minimal_nerf_torch.models.mlp import (  # noqa: F401
    init_nerf_mlp,
    nerf_mlp_apply,
    params_from_jax,
    params_to_numpy,
)
from minimal_nerf_torch.models.nerf import (  # noqa: F401
    NeRFConfig,
    init_nerf_network,
    render_rays,
)
