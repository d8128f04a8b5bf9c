from quickrank_tpu_torch.learning.base import LTRAlgorithm
from quickrank_tpu_torch.learning.dart import Dart
from quickrank_tpu_torch.learning.lambdamart import LambdaMart
from quickrank_tpu_torch.learning.mart import Mart
from quickrank_tpu_torch.learning.obliviousmart import ObliviousLambdaMart, ObliviousMart

__all__ = ["Dart", "LTRAlgorithm", "LambdaMart", "Mart", "ObliviousLambdaMart",
           "ObliviousMart"]
