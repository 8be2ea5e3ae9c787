from . import train
