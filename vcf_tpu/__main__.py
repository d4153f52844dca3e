import sys

from vcf_tpu.cli import main
from vcf_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()
sys.exit(main())
