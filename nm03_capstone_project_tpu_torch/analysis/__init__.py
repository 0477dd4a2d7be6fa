"""The port's static analysis (``nm03-lint``) — docs/STATIC_ANALYSIS_TORCH.md.

The counterpart of the JAX package's ``analysis/``, over the PyTorch port:
``python -m nm03_capstone_project_tpu_torch.analysis.cli`` lints, and
``python -m nm03_capstone_project_tpu_torch.analysis.gate`` runs the whole
gate (parse, lint against ``nm03lint_torch_baseline.json``, ruff, and the
lockdep witness). Stdlib-only at import by contract, and self-enforced:
this package registers itself in its own import-contract registry.
"""

from nm03_capstone_project_tpu_torch.analysis.core import (  # noqa: F401
    Finding,
    SourceFile,
    apply_baseline,
    collect_files,
    find_repo_root,
    load_baseline,
    run_rules,
    write_baseline,
)
from nm03_capstone_project_tpu_torch.analysis.cli import (  # noqa: F401
    ALL_RULES,
    RULE_CATALOG,
    main,
)
