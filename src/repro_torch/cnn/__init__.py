# CNN executors of the port: the CIM-mapped convolutions in PyTorch.
# cim_conv.py    reference placement-batched executor (single implicit macro)
# mapped_net.py  macro-parallel executor: the macro grid as einsum axes,
#                or over a device mesh (launch/mesh.py)
# weights.py     kernels and parameters carried across from the JAX package
# models.py      benchmark CNNs over parameter trees (apply_cnn)
# train.py       the Table II trainer and the plan trainer
from .cim_conv import (build_weight_matrix, cim_conv2d, gather_patches,
                       placement_groups, reference_conv2d, scatter_indices,
                       window_placements)
from .mapped_net import (assert_steps_match, check_steps, executed_steps,
                         layer_schedule, mapped_conv2d, mapped_net_apply,
                         network_schedule, prepared_layer_weights,
                         reference_net_apply, zero_pruned_kernels)
from .weights import kernels_from_numpy, params_from_numpy
