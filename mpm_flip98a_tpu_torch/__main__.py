from mpm_flip98a_tpu_torch.driver import main

main()
