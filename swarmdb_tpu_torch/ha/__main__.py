"""``python -m swarmdb_tpu_torch.ha`` — alias for the HA node CLI."""

from .node import main

raise SystemExit(main())
