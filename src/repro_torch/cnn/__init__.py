# CNN executors of the port: the CIM-mapped convolutions in PyTorch.
# cim_conv.py    reference placement-batched executor (single implicit macro)
# mapped_net.py  macro-parallel executor: the macro grid as einsum axes
# weights.py     kernels carried across from the JAX package (numpy)
from .cim_conv import (build_weight_matrix, cim_conv2d, gather_patches,
                       placement_groups, reference_conv2d, scatter_indices,
                       window_placements)
from .mapped_net import (check_steps, executed_steps, layer_schedule,
                         mapped_conv2d, mapped_net_apply,
                         prepared_layer_weights, reference_net_apply,
                         zero_pruned_kernels)
from .weights import kernels_from_numpy
