from .kernels import (bdot, bdot_plain, build, freq_divide, freq_divide_plain,
                      fused_admm_update, fused_admm_update_plain, fused_cg_tail,
                      fused_cg_tail_plain, launch_counts, reset_launches,
                      tv_denoise_chw, tv_denoise_chw_plain, tv_denoise_chw_vjp,
                      tv_denoise_chw_vjp_plain)
