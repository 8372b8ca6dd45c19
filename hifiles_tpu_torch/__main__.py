import sys

from .driver import main

sys.exit(main())
