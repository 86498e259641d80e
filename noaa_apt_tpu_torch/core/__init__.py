from .frequency import Freq, Rate
from .filters import Lowpass, LowpassDcRemoval, NoFilter, kaiser, bessel_i0
