from .ik import IKConfig, solve_ck_ik
