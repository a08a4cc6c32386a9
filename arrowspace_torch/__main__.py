"""`python -m arrowspace_torch` — analogue of the reference's trivial
binary (src/main.rs: init logging and exit): prints the package, torch
and CUDA versions and the cards it sees.  It builds and runs no
kernel."""

import torch

from . import __version__, init

init()
cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
names = ", ".join(torch.cuda.get_device_name(i) for i in range(cards))
print(f"arrowspace-torch {__version__} — torch {torch.__version__}, "
      f"CUDA {torch.version.cuda or 'none'}, devices: {cards}"
      + (f" ({names})" if names else ""))
