from .frequency import Freq, Rate
from .filters import Lowpass, LowpassDcRemoval, kaiser, bessel_i0
