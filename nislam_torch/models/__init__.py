"""Model families composed from the core layers.

- :class:`~nislam_torch.models.registration.KCCRegistration`: standalone
  pairwise and batched image registration (the bare KCC engine);
- :class:`~nislam_torch.models.vo.VisualOdometry`: frame-to-keyframe
  tracking without loop closure or optimization;
- :class:`~nislam_torch.models.slam.FullSlam`: the complete system,
  tracking, loop closure, pose graph and map stitching.

Each takes its config and a ``device``, the card unless the caller asks
for another.
"""

from nislam_torch.models.registration import KCCRegistration  # noqa: F401
from nislam_torch.models.slam import FullSlam, SlamEvalResult  # noqa: F401
from nislam_torch.models.vo import EvalResult, VisualOdometry  # noqa: F401
