"""The six experiment drivers of the reference, over ``TrainAndTest``."""
from .drivers import (
    CompareCrossModalType,
    CompareModal,
    CompareModelInitWeight,
    ComparePrivacyBudget,
    ComparePrivateScheme,
    Demo,
)
