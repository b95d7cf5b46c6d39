from . import caf, codes, corr, geodesy, interp, iq, pathloss, power, spectral
from . import fftcore
