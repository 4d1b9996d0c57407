"""Back-project per-frame RGB colours onto scene points, averaged across
views (counterpart of ``scripts/project_multiview_color.py``): an alias of
``project_multiview_labels --what color``.

Demo: ``python -m bridgeqa_tpu_torch.scripts.project_multiview_color --synthetic
--device cpu --out /tmp/col``
"""

import sys

from bridgeqa_tpu_torch.scripts import project_multiview_labels as _labels


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    return _labels.main(argv + ["--what", "color"])


if __name__ == "__main__":
    main()
