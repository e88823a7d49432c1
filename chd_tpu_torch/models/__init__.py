from . import contact_mlp
