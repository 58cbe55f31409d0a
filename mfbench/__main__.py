import sys

from mfbench.run import main

sys.exit(main())
