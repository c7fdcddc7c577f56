"""`python -m mitsuba_tpu` entry point."""
from .cli import main

raise SystemExit(main())
