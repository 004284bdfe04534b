"""Weight bridge and seeded initialisation for the port."""
from feat3dnet_tpu_torch.utils.convert import (load_variables,
                                               state_dict_from_variables,
                                               variables_from_module)
from feat3dnet_tpu_torch.utils.init import init_variables

__all__ = ["init_variables", "load_variables", "state_dict_from_variables",
           "variables_from_module"]
