from quickrank_tpu_torch.learning.base import LTRAlgorithm
from quickrank_tpu_torch.learning.custom import CustomLTR
from quickrank_tpu_torch.learning.dart import Dart
from quickrank_tpu_torch.learning.lambdamart import LambdaMart
from quickrank_tpu_torch.learning.linear import CoordinateAscent, LineSearch
from quickrank_tpu_torch.learning.mart import Mart
from quickrank_tpu_torch.learning.meta import MetaCleaver
from quickrank_tpu_torch.learning.obliviousmart import ObliviousLambdaMart, ObliviousMart
from quickrank_tpu_torch.learning.randomforest import RandomForest
from quickrank_tpu_torch.learning.rankboost import RankBoost
from quickrank_tpu_torch.learning.selective import LambdaMartSelective
from quickrank_tpu_torch.learning.stochasticnegative import StochasticNegative

__all__ = ["CoordinateAscent", "CustomLTR", "Dart", "LTRAlgorithm", "LambdaMart",
           "LambdaMartSelective", "LineSearch", "Mart", "MetaCleaver", "ObliviousLambdaMart",
           "ObliviousMart", "RandomForest", "RankBoost", "StochasticNegative"]
