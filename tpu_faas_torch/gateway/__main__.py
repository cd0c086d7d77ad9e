from tpu_faas_torch.gateway.app import main

if __name__ == "__main__":
    main()
