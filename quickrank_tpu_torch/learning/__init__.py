from quickrank_tpu_torch.learning.base import LTRAlgorithm
from quickrank_tpu_torch.learning.dart import Dart
from quickrank_tpu_torch.learning.lambdamart import LambdaMart
from quickrank_tpu_torch.learning.linear import CoordinateAscent, LineSearch
from quickrank_tpu_torch.learning.mart import Mart
from quickrank_tpu_torch.learning.meta import MetaCleaver
from quickrank_tpu_torch.learning.obliviousmart import ObliviousLambdaMart, ObliviousMart

__all__ = ["CoordinateAscent", "Dart", "LTRAlgorithm", "LambdaMart", "LineSearch", "Mart",
           "MetaCleaver", "ObliviousLambdaMart", "ObliviousMart"]
